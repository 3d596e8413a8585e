"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py`` or the port's ``tools/``) imports JAX or the JAX package, every CUDA source
is in the build, and the kernel wrappers take their plain versions only for CPU tensors."""
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
            + sorted((ROOT / "tools").glob("*.py")))


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 10
    # the training slice's subpackages are among the files checked
    pkg = ROOT / "src" / "repro_torch"
    for sub in ("optim", "data", "train", "kernels", "models"):
        assert any(f.parent == pkg / sub for f in files), sub
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
    assert {"fused_engine.cu", "fused_engine_bwd.cu", "conv_engine.cu", "domain_engine.cu"} <= set(sources)
    for name in sources:
        # a plain C interface bound with ctypes: the CUDA runtime and nothing of PyTorch
        includes = set(re.findall(r"^#include\s+(\S+)", (_build.CSRC / name).read_text(), re.M))
        assert includes <= {"<cuda_runtime.h>", "<stdint.h>"}, (name, includes)
    for fn in ("fused_engine_bwd_x_f32", "fused_engine_bwd_w_f32", "fused_engine_bwd_x_plan",
               "fused_engine_bwd_w_plan", "fused_engine_epi_f32", "fused_engine_plan",
               "conv_engine_fwd_plan", "conv_engine_fwd_f32", "conv_engine_bwd_x_plan", "conv_engine_bwd_x_f32",
               "conv_engine_bwd_w_plan", "conv_engine_bwd_w_f32", "domain_engine_fwd_plan", "domain_engine_fwd_f32",
               "domain_engine_bwd_x_plan", "domain_engine_bwd_x_f32", "domain_engine_bwd_w_plan",
               "domain_engine_bwd_w_f32"):
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
