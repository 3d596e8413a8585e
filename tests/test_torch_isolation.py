"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``, the port's ``tools/`` or its ``examples/torch_*.py``)
imports JAX or the JAX package, every CUDA source is in the build, and the
kernel wrappers take their plain versions only for CPU tensors."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.core import DeconvDims
from repro_torch.kernels import engine as E
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s|$))", re.M)


def _port_files():
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py")) + sorted((ROOT / "examples").glob("torch_*.py")))


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 10
    # the training slice's subpackages are among the files checked
    pkg = ROOT / "src" / "repro_torch"
    for sub in ("optim", "data", "train", "kernels", "models", "parallel", "launch"):
        assert any(f.parent == pkg / sub for f in files), sub
    for name in ("checkpoint.py", "resilience.py", "trainer.py"):  # the training loop's modules
        assert pkg / "train" / name in files, name
    for name in ("sharding.py", "compression.py", "overlap.py"):  # the multi-device modules
        assert pkg / "parallel" / name in files, name
    for name in ("mesh.py", "steps.py", "train.py"):  # the launch package: the mesh, the steps, the launcher
        assert pkg / "launch" / name in files, name
    assert ROOT / "examples" / "torch_train_dcgan.py" in files
    assert ROOT / "examples" / "torch_train_lm.py" in files
    for name in ("lm.py", "attention.py", "mlp.py", "moe.py", "ssm.py"):  # the LM stack's modules
        assert pkg / "models" / name in files, name
    for name in ("phi3_mini_3_8b", "starcoder2_15b", "gemma3_12b", "llama3_8b", "musicgen_medium", "jamba_v0_1_52b",
                 "llama4_scout_17b_a16e", "mixtral_8x22b", "mamba2_780m", "qwen2_vl_2b"):  # the ten LM configs
        assert pkg / "configs" / f"{name}.py" in files, name
    assert ROOT / "examples" / "torch_serve_lm.py" in files
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad


def test_forbidden_pattern_spares_the_port_itself():
    assert FORBIDDEN.search("import repro.core") and FORBIDDEN.search("from repro import x")
    assert FORBIDDEN.search("import jax.numpy as jnp") and FORBIDDEN.search("  from jax import lax")
    assert not FORBIDDEN.search("from repro_torch.kernels import ops")
    assert not FORBIDDEN.search("import repro_torch")


def _case(device="cpu"):
    dims = DeconvDims(5, 2, 2, 1)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 4, 4, 3), generator=g)
    w = torch.randn((5, 5, 3, 2), generator=g)
    return ops.cells_from_image(x, dims).to(device), ops.prepack(w, dims), dims


def test_cpu_tensors_take_the_plain_version_without_counting_a_launch():
    cells, packed, dims = _case()
    before = E.fused_engine.launches
    out = ops.winograd_deconv2d_cells(cells, packed, dims, (4, 4), epilogue="tanh")
    assert out.shape == (1, 8, 8, 2)
    assert E.fused_engine.launches == before


def test_cuda_request_without_a_card_raises():
    """A CUDA device never degrades to a CPU result: without a card the
    tensors cannot get there, and a non-CPU, non-CUDA tensor is refused."""
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without CUDA")
    cells, packed, dims = _case()
    with pytest.raises((RuntimeError, AssertionError)):
        ops.winograd_deconv2d_cells(cells.to("cuda"), packed, dims, (4, 4))
    from repro_torch.configs import tiny_dcgan
    from repro_torch.models import gan as G

    with pytest.raises((RuntimeError, AssertionError)):
        G.generator_init(tiny_dcgan(), device="cuda")
    meta = cells.to("meta")
    before = E.fused_engine.launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.winograd_deconv2d_cells(meta, ops.PackedDeconv(packed.ww.to("meta"), packed.inv.to("meta")),
                                    dims, (4, 4))
    assert E.fused_engine.launches == before


def test_every_cuda_source_is_built_and_imports_nothing_of_the_reference():
    from repro_torch.kernels import _build

    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert sources == sorted(_build.SOURCES)
    assert {"fused_engine.cu", "fused_engine_bwd.cu", "conv_engine.cu", "domain_engine.cu", "engine1d.cu"} <= set(sources)
    headers = {f'"{p.name}"' for p in _build.CSRC.glob("*.cuh")}
    for name in sources + sorted(p.name for p in _build.CSRC.glob("*.cuh")):
        # a plain C interface bound with ctypes: the CUDA runtime, the
        # package's own headers and nothing of PyTorch; <cuda.h> for its
        # types only (the tensor-map encoder comes through the runtime's
        # entry-point query: nothing links libcuda)
        text = (_build.CSRC / name).read_text()
        includes = set(re.findall(r"^#include\s+(\S+)", text, re.M))
        assert includes <= {"<cuda_runtime.h>", "<stdint.h>", "<cuda.h>"} | headers, (name, includes)
        if "<cuda.h>" in includes:
            assert "cudaGetDriverEntryPoint" in text and not re.search(r"(?<![\w.])cu[A-Z]\w*\(", text), name
    assert not any("lcuda" in f for f in _build.NVCC_FLAGS)
    for fn in ("fused_engine_bwd_x_f32", "fused_engine_bwd_w_f32", "fused_engine_bwd_x_plan",
               "fused_engine_bwd_w_plan", "fused_engine_epi_f32", "fused_engine_plan",
               "conv_engine_fwd_plan", "conv_engine_fwd_f32", "conv_engine_bwd_x_plan", "conv_engine_bwd_x_f32",
               "conv_engine_bwd_w_plan", "conv_engine_bwd_w_f32", "domain_engine_fwd_plan", "domain_engine_fwd_f32",
               "domain_engine_bwd_x_plan", "domain_engine_bwd_x_f32", "domain_engine_bwd_w_plan",
               "domain_engine_bwd_w_f32", "engine1d_plan", "engine1d_f32"):
        assert fn in _build._SIGNATURES


def test_bwd_wrappers_take_the_plain_versions_on_cpu_without_counting():
    cells, packed, dims = _case()
    pos, subs, inv, _ = ops.packed_layout(dims)
    g = torch.randn((1, 3, 3, 16, 2))
    geo = dict(pos_idx=pos, sub_slices=subs, m=2, n=4, ty=3, tx=3, stride=2)
    before = (E.fused_engine_bwd_x.launches, E.fused_engine_bwd_w.launches)
    dx = E.fused_engine_bwd_x(g, packed.ww, packed.inv, gy=cells.shape[1], gx=cells.shape[2], **geo)
    dw = E.fused_engine_bwd_w(cells, g, packed.inv, **geo)
    assert dx.shape == cells.shape and dw.shape == packed.ww.shape
    assert (E.fused_engine_bwd_x.launches, E.fused_engine_bwd_w.launches) == before


def test_conv_wrappers_take_the_plain_versions_on_cpu_without_counting():
    from repro_torch.core import conv_same_dims

    cd = conv_same_dims(4, 2, 8)
    x = torch.randn((1, 8, 8, 3), generator=torch.Generator().manual_seed(1))
    packed = ops.prepack_conv(torch.randn((4, 4, 3, 2)), cd)
    cells = ops.conv_cells_from_image(x, cd)
    geo = dict(pos_idx=ops.conv_packed_layout(cd)[0], m=2, n=4, ty=2, tx=2, s2=4)
    counters = (E.conv_fused_engine, E.conv_fused_engine_bwd_x, E.conv_fused_engine_bwd_w)
    before = [f.launches for f in counters]
    y = E.conv_fused_engine(cells, packed.ww, packed.inv, out_mode="cells", activation="leaky_relu", out_h=4,
                            out_w=4, **geo)
    g = torch.randn((1, 2, 2, 4, 2))
    dx = E.conv_fused_engine_bwd_x(g, packed.ww, packed.inv, gy=cells.shape[1], gx=cells.shape[2], **geo)
    dw = E.conv_fused_engine_bwd_w(cells, g, packed.inv, **geo)
    assert y.shape == (1, 2, 2, 4, 2) and dx.shape == cells.shape and dw.shape == packed.ww.shape
    assert [f.launches for f in counters] == before


def _case_1d():
    from repro_torch.core.winograd import get_transform

    dims = DeconvDims(4, 2, 1, 0)
    pos, subs, _, _ = ops.packed_deconv1d_layout(dims)
    packed = ops.prepack_deconv1d(torch.randn((4, 8, 4), generator=torch.Generator().manual_seed(2)), dims)
    cells = torch.randn((2, 6, 2, 8), generator=torch.Generator().manual_seed(3))
    bt = tuple(tuple(float(v) for v in row) for row in get_transform(2, 3).BT)
    return cells, packed, bt, dict(pos_idx=pos, sub_slices=subs, m=2, n=4, ty=5)


def test_1d_wrappers_take_the_plain_versions_on_cpu_without_counting():
    cells, packed, bt, kw = _case_1d()
    f = E.winograd_conv1d_fused_engine
    counters = [(f, "launches"), (f, "scratch_launches"), (E.domain_engine_bwd_x, "rank1_launches"),
                (E.domain_engine_bwd_w, "rank1_launches")]
    before = [getattr(c, a) for c, a in counters]
    y = f(cells, packed.ww, packed.inv, bt, out_mode="nlc", activation="relu", stride=2, **kw)
    scr = f(cells, packed.ww, packed.inv, bt, out_mode="scratch", **kw)
    assert torch.equal(y, E.winograd_conv1d_fused_engine_plain(cells, packed.ww, packed.inv, bt, activation="relu",
                                                               stride=2, **kw))
    g = torch.randn(scr.shape)
    dx = E.winograd_conv1d_fused_bwd_x(g, packed.ww, packed.inv, bt, gy=cells.shape[1], **kw)
    dw = E.winograd_conv1d_fused_bwd_w(cells, g, packed.inv, bt, **kw)
    assert y.shape == (2, 20, 4) and scr.shape == (2, 5, 4, 4) and dx.shape == cells.shape
    assert dw.shape == packed.ww.shape
    assert [getattr(c, a) for c, a in counters] == before


def test_1d_wrappers_raise_for_other_devices_and_bad_arguments():
    cells, packed, bt, kw = _case_1d()
    f = E.winograd_conv1d_fused_engine
    meta = dict(ww_packed=packed.ww.to("meta"), inv_packed=packed.inv.to("meta"))
    before = (f.launches, f.scratch_launches, E.domain_engine_bwd_x.rank1_launches)
    with pytest.raises(ValueError, match="cpu or cuda"):
        f(cells.to("meta"), bt_mat=bt, stride=2, **meta, **kw)
    with pytest.raises(ValueError, match="cpu or cuda"):
        E.winograd_conv1d_fused_bwd_x(torch.empty((2, 5, 4, 4), device="meta"), packed.ww.to("meta"),
                                      packed.inv.to("meta"), bt, gy=6, **kw)
    with pytest.raises(ValueError, match="out_mode"):
        f(cells, packed.ww, packed.inv, bt, out_mode="nhwc", **kw)
    with pytest.raises(ValueError, match="no epilogue"):
        f(cells, packed.ww, packed.inv, bt, out_mode="scratch", activation="tanh", **kw)
    assert (f.launches, f.scratch_launches, E.domain_engine_bwd_x.rank1_launches) == before


@pytest.mark.parametrize("bad", ["m", "phases", "stride", "channels", "sub_slices", "positions", "dtype"])
def test_1d_kernel_check_refuses_shapes_it_does_not_cover(bad):
    """What a CUDA tensor's launch would be refused for, checked on CPU
    tensors by the same function the wrapper calls before launching."""
    cells, packed, bt, kw = _case_1d()
    ww, inv = packed.ww, packed.inv
    args = dict(out_mode="nlc", stride=2, scale=None, bias=None, phases=1, **kw)
    E._check_engine1d(cells, ww, inv, bt, **args)  # the case itself is covered
    if bad == "m":
        args["m"] = 4
    elif bad == "phases":
        args["phases"] = 4
    elif bad == "stride":
        args["stride"] = 1
    elif bad == "channels":
        cells, ww = cells[..., :6].contiguous(), ww[:, :6].contiguous()
    elif bad == "sub_slices":
        args["sub_slices"] = ((0, 3), (4, 6))
    elif bad == "positions":
        args["pos_idx"] = (0, 1, 2, 1, 2, 4)
    else:
        cells = cells.double()
    with pytest.raises(ValueError):
        E._check_engine1d(cells, ww, inv, bt, **args)


@pytest.mark.parametrize("bad", ["m2", "n2_2d", "n2_big", "inv", "position"])
def test_rank1_domain_check_refuses_what_the_kernels_do_not_take(bad):
    """Kernels 4 and 5 take m2 = 2 with n2 <= 16, or m2 = 4 with n2 = 16,
    and nothing else; kernel 1 keeps m2 = 4 only."""
    pos, subs, inv, _ = ops.packed_deconv1d_layout(DeconvDims(4, 2, 1, 0))
    g = torch.zeros((3, 4, 5))
    kw = dict(pos_idx=pos, sub_slices=subs, m2=2, T=3, N=8, M=5, n2=4, ranks=(2, 4))
    E._check_domain((("g", g),), **kw)
    with pytest.raises(ValueError, match="m2"):
        E._check_domain((("g", g),), **{**kw, "ranks": (4,)})  # kernel 1
    if bad == "m2":
        kw["m2"] = 3
    elif bad == "n2_2d":
        kw.update(m2=4, n2=4)
    elif bad == "n2_big":
        kw["n2"] = 17
    elif bad == "position":
        kw["n2"] = 2  # positions 2 and 3 fall outside
    if bad == "inv":
        with pytest.raises(ValueError, match="inv_packed"):
            E._check_packed(None, torch.zeros((6, 4)), 6, m2=2)
        return
    with pytest.raises(ValueError):
        E._check_domain((("g", g),), **kw)


# Where each wrapper's kernel moves an operand's rows in 16-byte copies, read
# off the kernels' configuration choices (csrc/*.cu): the deconv corner's and the 1D engine's weights at M % 4
# == 0 and M >= 16 (their tensor-core kernels, fwd_core.cuh, where the grid fills the card; held at any
# grid); the conv corner's forward weights at M >= 16 where N % 4 == 0 (its tensor-core kernel), else at M
# >= 32 (the CUDA-core kernel), the unfused engine's at M >= 32 (its CUDA-core forward: the tensor-core
# forward reads ww through its pack kernel, the few-channel one in 4-byte copies); bwd_x's g and weights at
# M >= 8 (the tensor cores); bwd_w's g at M >= 16; the deconv corner's and the 1D engine's cells and the
# unfused engine's xw always (N % 4 == 0 is required; the unfused forward's tensor-core kernel reads xw by
# TMA, whose base must be 16-byte aligned and whose row stride N*4 bytes a multiple of 16); the conv
# corner's cells where N % 4 == 0.
def _moves_16_bytes(wrapper, operand, N, M):
    if operand == "cells" and wrapper.startswith("conv_"):
        return N % 4 == 0
    if operand in ("cells", "xw"):
        return True
    if wrapper in ("winograd_conv1d_fused_engine", "fused_engine"):
        return M % 4 == 0 and M >= 16
    if wrapper == "conv_fused_engine":
        return M % 4 == 0 and M >= (16 if N % 4 == 0 else 32)
    least = 8 if wrapper.endswith("bwd_x") else 16 if wrapper.endswith("bwd_w") else 32
    return M % 4 == 0 and M >= least


_OPERANDS = [(w, o) for w, ops_ in (
    ("fused_engine", ("cells", "ww_packed")), ("fused_engine_bwd_x", ("g", "ww_packed")),
    ("fused_engine_bwd_w", ("cells", "g")), ("conv_fused_engine", ("cells", "ww_packed")),
    ("conv_fused_engine_bwd_x", ("g", "ww_packed")), ("conv_fused_engine_bwd_w", ("cells", "g")),
    ("domain_engine", ("xw", "ww_packed")), ("domain_engine_bwd_x", ("g", "ww_packed")),
    ("domain_engine_bwd_w", ("xw", "g")), ("winograd_conv1d_fused_engine", ("cells", "ww_packed"))) for o in ops_]


@pytest.mark.parametrize("N,M", [(64, 3), (64, 4), (64, 8), (64, 16), (64, 64), (6, 64), (6, 16)])
@pytest.mark.parametrize("wrapper,operand", _OPERANDS, ids=[f"{w}.{o}" for w, o in _OPERANDS])
def test_wrappers_refuse_misaligned_operands_of_16_byte_copies(wrapper, operand, N, M):
    """Every wrapper whose kernel moves an operand in 16-byte copies refuses
    that operand where it starts off a 16-byte boundary (a contiguous view
    ``buf[1:]``, which would fault in the kernel and lose the CUDA context),
    before any launch; where the kernel moves it in 4-byte copies (few or
    ragged channels) the view is taken."""
    def tensor(misaligned):
        buf = torch.zeros(8 * M + 1)  # the allocator's base is 16-byte aligned
        return buf[1:] if misaligned else buf[:-1]

    assert tensor(False).data_ptr() % 16 == 0 and tensor(True).data_ptr() % 16 == 4
    assert {o for w, o in _OPERANDS if w == wrapper} == set(E._SIXTEEN_BYTE_COPIES[wrapper])
    operands = {o: tensor(o == operand) for o in E._SIXTEEN_BYTE_COPIES[wrapper]}
    if _moves_16_bytes(wrapper, operand, N, M):
        with pytest.raises(ValueError, match=f"16-byte.*{operand} must start"):
            E._check_aligned(wrapper, N, M, **operands)
    else:
        E._check_aligned(wrapper, N, M, **operands)
    E._check_aligned(wrapper, N, M, **{o: tensor(False) for o in operands})  # aligned: always taken


@pytest.mark.parametrize("bad", ["n", "misaligned"])
def test_unfused_forward_refuses_what_tma_and_16_byte_copies_cannot_take(bad):
    """The unfused forward's launch path refuses, before it loads the
    library, an N that is not a multiple of 4 (the tensor map's row stride
    of N*4 bytes must be a multiple of 16, as the 16-byte copies need) and
    an xw that starts off a 16-byte boundary (the tensor map's base)."""
    pos, subs, inv, _ = ops.packed_layout(DeconvDims(5, 2, 2, 1))
    N = 6 if bad == "n" else 8
    xw = torch.zeros(3 * 16 * N + 1)
    xw = (xw[1:] if bad == "misaligned" else xw[:-1]).view(3, 16, N)
    ww = torch.zeros((len(pos), N, 36))
    with pytest.raises(ValueError, match="multiple of 4" if bad == "n" else "16-byte"):
        E._domain_fwd(xw, ww, torch.as_tensor(inv), pos_idx=pos, sub_slices=subs, m2=4)


# Which operands each instantiation moves in 16-byte copies (cp.async of 16 bytes, or TMA), read off the
# kernels (csrc/*.cu): the CUDA-core forwards' weights where their block configuration takes 4 of them a copy
# (VW = 4: M >= 32, M % 4 == 0), the conv corner's windows where N % 4 == 0 and its CUDA-core bwd_w's g rows
# for N % 4 != 0 and M >= 16; every tensor-core kernel its weights or g rows (the unfused forward's reads xw by
# TMA and its weights through the pack kernel); the deconv corner's, the 1D engine's and the unfused engine's
# cells / xw always.
def _forced_copies(kernel, conf, N, M):
    wide, cuda = M >= 32 and M % 4 == 0, conf == "cuda_cores"
    if kernel in ("fused_engine", "winograd_conv1d_fused_engine"):
        return {"cells"} | ({"ww_packed"} if wide or not cuda else set())
    if kernel.endswith("bwd_x"):
        return set() if cuda else {"g", "ww_packed"}
    if kernel == "fused_engine_bwd_w":
        return {"cells"} | (set() if cuda else {"g"})
    if kernel == "conv_fused_engine":
        return ({"cells"} if N % 4 == 0 else set()) | ({"ww_packed"} if wide or not cuda else set())
    if kernel == "conv_fused_engine_bwd_w":
        if not cuda:
            return {"cells", "g"}
        return {"cells"} if N % 4 == 0 else ({"g"} if M >= 16 and M % 4 == 0 else set())
    if kernel == "domain_engine":
        return {"xw"} | ({"ww_packed"} if cuda and wide else set())
    assert kernel == "domain_engine_bwd_w"
    return {"xw"} | (set() if cuda else {"g"})


@pytest.mark.parametrize("kernel", list(E.INSTANTIATIONS))
def test_misaligned_operands_are_refused_under_every_forced_instantiation(kernel):
    """``_SIXTEEN_BYTE_COPIES`` holds at any grid, so a forced instantiation
    (``conf=``) never meets a misaligned operand it copies 16 bytes at a
    time: at every (N, M) and shape an instantiation takes, the operands it
    moves so are among those the wrapper refuses off a 16-byte boundary."""
    for N in (3, 4, 6, 8, 16, 64, 100):
        for M in (1, 3, 4, 6, 8, 12, 16, 24, 32, 36, 64):
            refused = {op for op, when in E._SIXTEEN_BYTE_COPIES[kernel].items() if when(N, M)}
            for conf in E.INSTANTIATIONS[kernel]:
                for shape in (dict(S=2, S2=4, C=36, M2=4, N2=16), dict(S=1, S2=1, C=5, M2=2, N2=4),
                              dict(S=1, S2=1, C=6, M2=2, N2=6)):
                    try:
                        E.request(kernel, conf, N=N, M=M, **shape)
                    except ValueError:
                        continue
                    assert _forced_copies(kernel, conf, N, M) <= refused, (kernel, conf, N, M)


def test_autotune_module_imports_no_jax_and_no_reference_package():
    files = _port_files()
    path = ROOT / "src" / "repro_torch" / "kernels" / "autotune.py"
    assert path in files
    assert not FORBIDDEN.search(path.read_text())
