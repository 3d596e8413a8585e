"""The port's op cost model (``launch/op_costs.py``) against the
reference's HLO cost model (``launch/hlo_costs.py``), and the kernels'
work counts (``kernels/costs.py``) against their closed forms.

* Single-op FLOPs: a matmul, a batched matmul, an einsum and a strided
  conv, eagerly under ``OpRecorder``, give exactly the FLOPs
  ``hlo_costs.analyze_text`` reads off the compiled HLO of the same JAX
  function.  f32 matmuls are classified f32 and bf16 ones are not.
* Collectives: each of the port's collectives on a fake subgroup of g
  ranks gives the wire bytes the reference's ``analyze_text`` gives for a
  synthetic HLO instruction of the same op and size.
* Kernels: every ``kernels/costs.py`` function at the smoke's shapes gives
  the products, ops and bytes that ``chip_smoke.py`` worked out inline
  before the counts moved into the package (the closed forms below), the
  smoke's kernel phases call them, and each wrapper's launch record carries
  the keywords its count takes.
"""
from __future__ import annotations

import ast
import inspect
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch.hlo_costs import analyze_text
from repro_torch.kernels import costs
from repro_torch.launch.op_costs import OpRecorder, analyze_records, collective_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(fn, *arrays):
    args = [torch.from_numpy(a) if a.dtype != np.dtype("bfloat16") else torch.from_numpy(a) for a in arrays]
    rec = OpRecorder()
    with rec:
        fn(*args)
    return analyze_records(rec.records)


def _ref(fn, *arrays):
    text = jax.jit(fn).lower(*[jnp.asarray(a) for a in arrays]).compile().as_text()
    return analyze_text(text, 1)


_RNG = np.random.default_rng(0)
SINGLE_OPS = {
    "matmul": (lambda a, b: a @ b, lambda a, b: a @ b,
               (_RNG.standard_normal((64, 96)), _RNG.standard_normal((96, 48)))),
    "bmm": (torch.bmm, lambda a, b: jnp.matmul(a, b),
            (_RNG.standard_normal((4, 32, 40)), _RNG.standard_normal((4, 40, 24)))),
    "einsum": (lambda a, b: torch.einsum("bhqd,bhkd->bhqk", a, b),
               lambda a, b: jnp.einsum("bhqd,bhkd->bhqk", a, b),
               (_RNG.standard_normal((2, 3, 16, 8)), _RNG.standard_normal((2, 3, 20, 8)))),
    # a strided conv (K4S2, as the GAN discriminators'): NCHW in the port, NHWC in JAX
    "conv_k4s2": (lambda x, w: torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=2,
                                                          padding=1),
                  lambda x, w: jax.lax.conv_general_dilated(x, w, (2, 2), ((1, 1), (1, 1)),
                                                            dimension_numbers=("NHWC", "HWIO", "NHWC")),
                  (_RNG.standard_normal((2, 16, 16, 12)), _RNG.standard_normal((4, 4, 12, 20)))),
}


@pytest.mark.parametrize("name", sorted(SINGLE_OPS))
def test_single_op_flops_equal_the_reference(name):
    port_fn, ref_fn, arrays = SINGLE_OPS[name]
    arrays = [a.astype(np.float32) for a in arrays]
    got, want = _port(port_fn, *arrays), _ref(ref_fn, *arrays)
    assert got["flops_per_device"] == want["flops_per_device"] > 0
    assert got["f32_matmul_flops_per_device"] == (want["f32_matmul_flops_per_device"] if name != "conv_k4s2" else 0)


@pytest.mark.parametrize("name", ["matmul", "bmm", "einsum"])
def test_f32_matmuls_are_f32_and_bf16_ones_are_not(name):
    port_fn, _, arrays = SINGLE_OPS[name]
    f32 = _port(port_fn, *[a.astype(np.float32) for a in arrays])
    rec = OpRecorder()
    with rec:
        port_fn(*[torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) for a in arrays])
    bf16 = analyze_records(rec.records)
    assert f32["f32_matmul_flops_per_device"] == f32["flops_per_device"] > 0
    assert bf16["f32_matmul_flops_per_device"] == 0
    assert bf16["bf16_matmul_flops_per_device"] == f32["flops_per_device"]


# ------------------------------------------------------------ collectives
@pytest.fixture(scope="module")
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    groups = {g: dist.new_group(list(range(g))) for g in (2, 4, 8)}
    yield groups
    dist.destroy_process_group()


def _hlo(op_line: str, in_shape: str) -> str:
    return textwrap.dedent(f"""
        HloModule test

        %add (x: f32[], y: f32[]) -> f32[] {{
          %x = f32[] parameter(0)
          %y = f32[] parameter(1)
          ROOT %s = f32[] add(%x, %y)
        }}

        ENTRY %main (a: f32[{in_shape}]) -> f32[] {{
          %a = f32[{in_shape}]{{1,0}} parameter(0)
          {op_line}
          ROOT %z = f32[] constant(0)
        }}
        """)


def _port_collective(name: str, g: int, group):
    x = torch.zeros(64, 32)
    with OpRecorder() as rec:
        if name == "all-reduce":
            dist.all_reduce(x, group=group)
        elif name == "all-gather":
            dist.all_gather([torch.empty_like(x) for _ in range(g)], x, group=group)
        elif name == "all-gather-base":
            dist.all_gather_into_tensor(torch.empty(64 * g, 32), x, group=group)
        elif name == "reduce-scatter":
            dist.reduce_scatter_tensor(torch.empty(64 // g, 32), x, group=group)
        elif name == "reduce-scatter-list":
            dist.reduce_scatter(torch.empty(64 // g, 32), list(x.chunk(g)), group=group)
        elif name == "all-to-all":
            dist.all_to_all_single(torch.empty_like(x), x, group=group)
        elif name == "all-to-all-list":
            dist.all_to_all(list(torch.empty_like(x).chunk(g)), list(x.chunk(g)), group=group)
        elif name == "collective-permute":
            dist.send(x, 1)
    return collective_stats(rec.records)


_RG = "replica_groups=[{n},{g}]<=[8]"
_HLO_LINES = {  # the reference's instruction of the same op and size (f32[64,32] per rank)
    "all-reduce": ("%c = f32[64,32]{{1,0}} all-reduce(%a), " + _RG + ", to_apply=%add", "all-reduce"),
    "all-gather": ("%c = f32[{G},32]{{1,0}} all-gather(%a), " + _RG + ", dimensions={{0}}", "all-gather"),
    "all-gather-base": ("%c = f32[{G},32]{{1,0}} all-gather(%a), " + _RG + ", dimensions={{0}}", "all-gather"),
    "reduce-scatter": ("%c = f32[{S},32]{{1,0}} reduce-scatter(%a), " + _RG + ", dimensions={{0}}, to_apply=%add",
                       "reduce-scatter"),
    "reduce-scatter-list": ("%c = f32[{S},32]{{1,0}} reduce-scatter(%a), " + _RG
                            + ", dimensions={{0}}, to_apply=%add", "reduce-scatter"),
    "all-to-all": ("%c = f32[64,32]{{1,0}} all-to-all(%a), " + _RG + ", dimensions={{0}}", "all-to-all"),
    "all-to-all-list": ("%c = f32[64,32]{{1,0}} all-to-all(%a), " + _RG + ", dimensions={{0}}", "all-to-all"),
    "collective-permute": ("%c = f32[64,32]{{1,0}} collective-permute(%a), source_target_pairs={{{{0,1}}}}",
                           "collective-permute"),
}


@pytest.mark.parametrize("g", (2, 4, 8))
@pytest.mark.parametrize("name", sorted(_HLO_LINES))
def test_collective_wire_bytes_equal_the_reference(fake_world, name, g):
    line, op = _HLO_LINES[name]
    ref = analyze_text(_hlo(line.format(n=8 // g, g=g, G=64 * g, S=64 // g), "64,32"), 8)
    got = _port_collective(name, g, fake_world[g])
    assert got["by_op"][op]["count"] == ref["collectives_by_op"][op]["count"] == 1
    assert got["wire_bytes_per_device"] == ref["collective_wire_bytes_per_device"] > 0


def test_a_group_of_one_moves_nothing_and_host_copies_count_apart(fake_world):
    one = dist.new_group([0])
    x = torch.zeros(16, 4)
    with OpRecorder() as rec:
        dist.all_reduce(x, group=one)
    got = analyze_records(rec.records)
    assert got["collectives_by_op"]["all-reduce"] == {"count": 1, "wire_bytes": 0}
    records = [{"op": "aten._to_copy.default", "in": [["float32", [16, 4], "cuda"]],
                "out": [["float32", [16, 4], "cpu"]]}]
    got = analyze_records(records)
    assert got["host_copy_bytes_per_device"] == 256 and got["hbm_bytes_per_device"] == 0


# ----------------------------------------------------------------- kernels
def _smoke():
    import sys

    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def _old_fused_fwd(T, C, N, M, inv, groups, phases, cells, out, vectors, epi):
    """chip_smoke.py's inline forms before the move (kernel, kernel_domain
    scratch, kernel_conv fwd)."""
    nz = np.asarray(inv) != 0

    def fold(groups, backward=False):
        return sum(min(int(np.maximum(nz[lo:hi].sum(axis=1 if backward else 0) - 1, 0).sum()),
                       12 if backward else 24) for lo, hi in groups)

    products = 2 * T * C * N * M
    ops = products + 32 * T * phases * N + T * M * fold(groups) + (3 * out if epi else 0)
    return products, ops, 4 * (cells + C * N * M + np.asarray(inv).size + out + M * vectors), fold


def _deconv_case(dims, B, H, N, M):
    from repro_torch.kernels import ops

    pos_idx, sub_slices, _, _ = ops.packed_layout(dims)
    inv = np.asarray(ops.packed_inv(dims, "cpu"))
    ty = -(-dims.j_extent(H) // 2)
    cells = ops.cells_from_image(torch.empty((B, H, H, N), device="meta"), dims)
    return pos_idx, sub_slices, inv, ty, cells


@pytest.mark.parametrize("layer", range(4))
@pytest.mark.parametrize("B", (8, 128))
def test_deconv_corner_counts_are_the_closed_forms(layer, B):
    from repro_torch.core.tdc import DeconvDims

    H, N, M = [(4, 1024, 512), (8, 512, 256), (16, 256, 128), (32, 128, 3)][layer]
    dims = DeconvDims(5, 2, 2, 1)
    pos_idx, sub_slices, inv, ty, cells = _deconv_case(dims, B, H, N, M)
    C, T, S = len(pos_idx), B * ty * ty, 2
    out = B * ty * S * ty * S * 4 * M  # cells mode
    for vectors, epi in ((2, True), (0, True), (0, False)):
        p, o, b, fold = _old_fused_fwd(T, C, N, M, inv, sub_slices, 1, cells.numel(), out, vectors, epi)
        got = costs.fused_engine(B=B, ty=ty, tx=ty, N=N, M=M, inv=inv, sub_slices=sub_slices, cells=cells.numel(),
                                 out=out, vectors=vectors, epilogue=epi)
        assert got == (p, o, b) and p == 2 * T * C * N * M
    gy = ty + 1
    common = 2 * T * C * N * M + T * M * fold(sub_slices, True) + 32 * T * N
    gs = B * ty * ty * S * S * 4 * M
    assert costs.fused_engine_bwd_x(B=B, ty=ty, tx=ty, gy=gy, gx=gy, N=N, M=M, inv=inv, sub_slices=sub_slices) == (
        2 * T * C * N * M, common + costs.overlap_adds(B, 1, N, ty, ty),
        4 * (gs + C * N * M + inv.size + B * gy * gy * 4 * N))
    assert costs.fused_engine_bwd_w(B=B, ty=ty, tx=ty, N=N, M=M, inv=inv, sub_slices=sub_slices,
                                    cells=cells.numel()) == (2 * T * C * N * M, common,
                                                             4 * (cells.numel() + gs + inv.size + C * N * M))
    # the unfused engine on the transformed tiles (kernels 1, 4, 5)
    kw = dict(T=T, n2=16, N=N, M=M, m2=4, inv=inv, sub_slices=sub_slices)
    io = {"fwd": T * 16 * N + C * N * M + T * S * S * 4 * M, "bwd_x": gs + C * N * M + T * 16 * N,
          "bwd_w": T * 16 * N + gs + C * N * M}
    for key, fn, backward in (("fwd", costs.domain_engine, False), ("bwd_x", costs.domain_engine_bwd_x, True),
                              ("bwd_w", costs.domain_engine_bwd_w, True)):
        assert fn(**kw) == (2 * T * C * N * M, 2 * T * C * N * M + T * M * fold(sub_slices, backward),
                            4 * (io[key] + inv.size))


@pytest.mark.parametrize("layer", range(4))
def test_conv_corner_counts_are_the_closed_forms(layer):
    from repro_torch.core import conv_same_dims
    from repro_torch.kernels import ops

    B, H, S = 128, 64 >> layer, 2
    N, M = [(3, 64), (64, 128), (128, 256), (256, 512)][layer]
    cd = conv_same_dims(4, S, H)
    pos_idx = ops.conv_packed_layout(cd)[0]
    inv = np.asarray(ops.conv_packed_inv(cd, "cpu"))
    C = len(pos_idx)
    cells = ops.conv_cells_from_image(torch.empty((B, H, H, N), device="meta"), cd)
    HO = cd.out_size(H)
    ty = tx = -(-HO // 2)
    gy, gx = cells.shape[1], cells.shape[2]
    T, out = B * ty * tx, B * ty * tx * 4 * M
    p, o, b, fold = _old_fused_fwd(T, C, N, M, inv, [(0, C)], S * S, cells.numel(), out, 1, True)
    kw = dict(B=B, ty=ty, tx=tx, N=N, M=M, inv=inv, s2=S * S)
    assert costs.conv_fused_engine(**kw, cells=cells.numel(), out=out, vectors=1) == (p, o, b)
    prod = 2 * T * C * N * M + 32 * T * S * S * N
    gw = T * M * fold([(0, C)], True)
    assert costs.conv_fused_engine_bwd_x(**kw, gy=gy, gx=gx) == (
        2 * T * C * N * M, prod + gw + costs.overlap_adds(B, S * S, N, ty, tx),
        4 * (T * 4 * M + C * N * M + inv.size + B * gy * gx * S * S * 4 * N))
    assert costs.conv_fused_engine_bwd_w(**kw, cells=cells.numel()) == (
        2 * T * C * N * M, prod + gw, 4 * (cells.numel() + T * 4 * M + inv.size + C * N * M))


@pytest.mark.parametrize("case", ("audio0", "audio1", "audio2", "conv1d_k4", "mamba_C3072", "mamba_C128"))
def test_1d_counts_are_the_closed_forms(case):
    from repro_torch.configs import audio_decoder
    from repro_torch.core.winograd import get_transform
    from repro_torch.kernels import ops

    smoke = _smoke()
    bt23 = tuple(tuple(float(v) for v in row) for row in get_transform(2, 3).BT)
    if case.startswith("audio"):
        i = int(case[-1])
        sp = audio_decoder(smoke.AUDIO_WIDTH)[i]
        B, L, N, M = smoke.AUDIO_BATCH, smoke.AUDIO_FRAMES * 2**i, sp.c_in, sp.c_out
        pos_idx, sub_slices, _, _ = ops.packed_deconv1d_layout(sp.dims)
        inv = np.asarray(ops.prepack_deconv1d(torch.zeros((sp.dims.kernel, 1, 1)), sp.dims).inv)
        cells, ty = ops.deconv1d_cells_from_seq(torch.empty((B, L, N), device="meta"), sp.dims)
        bt, n = bt23, 4
    else:
        K = 4
        B, L, N, M = (8, 2048, 256, 256) if case == "conv1d_k4" else (1, 259, int(case[7:]), int(case[7:]))
        pos_idx, sub_slices, inv, bt, n = ops.conv1d_layout(K)
        inv = np.asarray(inv)
        cells, ty, _ = ops.conv1d_cells_from_seq(torch.empty((B, L, N), device="meta"), K,
                                                 padding="causal" if case == "conv1d_k4" else "valid")
    T, C = B * ty, len(pos_idx)
    out = B * ty * 2 * len(sub_slices) * M
    for vectors, act, epi in ((0, "none", True), (2, "relu", True), (0, "none", False)):
        nz = (np.abs(np.asarray(bt)) != 0)
        t_ops = int(np.maximum(nz.sum(1) - 1, 0).sum() + (nz & (np.abs(np.asarray(bt)) != 1)).sum())
        epi_ops = out * (vectors + (act != "none")) if epi else 0
        want = (2 * T * C * N * M,
                2 * T * C * N * M + T * N * t_ops + T * M * costs.fold_ops_1d(inv, sub_slices) + epi_ops,
                4 * (cells.numel() + C * N * M + inv.size + out + M * vectors))
        got = costs.winograd_conv1d_fused_engine(B=B, ty=ty, N=N, M=M, phases=1, inv=inv, sub_slices=sub_slices, bt=bt,
                                                 cells=cells.numel(), out=out, vectors=vectors, activation=act,
                                                 epilogue=epi)
        assert got == want
    # rank-1 kernels 4 and 5 (m2 = 2): gw from g by fold_ops_1d over inv's rows
    kw = dict(T=T, n2=n, N=N, M=M, m2=2, inv=inv, sub_slices=sub_slices)
    gw = 2 * T * C * N * M + T * M * costs.fold_ops_1d(inv, sub_slices, backward=True)
    gs = T * len(sub_slices) * 2 * M
    assert costs.domain_engine_bwd_x(**kw) == (2 * T * C * N * M, gw, 4 * (gs + C * N * M + T * n * N + inv.size))
    assert costs.domain_engine_bwd_w(**kw) == (2 * T * C * N * M, gw, 4 * (T * n * N + gs + C * N * M + inv.size))


def test_the_smoke_takes_its_counts_from_the_package():
    smoke = _smoke()
    for helper in ("fold_adds", "overlap_adds", "transform_ops_1d", "fold_ops_1d"):
        assert not hasattr(smoke, helper), helper
    calls = {"kernel_phase": ["costs.fused_engine("], "kernel_bwd_phase": ["costs.fused_engine_bwd_x(",
                                                                           "costs.fused_engine_bwd_w("],
             "kernel_conv_phase": ["costs.conv_fused_engine(", "costs.conv_fused_engine_bwd_x(",
                                   "costs.conv_fused_engine_bwd_w("],
             "kernel_domain_phase": ["costs.domain_engine(", "costs.domain_engine_bwd_x(",
                                     "costs.domain_engine_bwd_w(", "costs.fused_engine("],
             "kernel_1d_phase": ["costs.winograd_conv1d_fused_engine(", "costs.domain_engine_bwd_x(",
                                 "costs.domain_engine_bwd_w("],
             "_lm_conv_checks": ["costs.winograd_conv1d_fused_engine("]}
    for phase, wanted in calls.items():
        src = inspect.getsource(getattr(smoke, phase))
        for call in wanted:
            assert call in src, (phase, call)


def test_every_launch_record_carries_its_counts_keywords():
    """Each ``_log`` call in engine.py passes ``work=dict(...)`` with
    exactly the keywords of its kernel's count (the CUDA path cannot run
    here, so the call sites are read)."""
    from repro_torch.kernels import engine

    tree = ast.parse(inspect.getsource(engine))
    seen = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_log":
            kernel = node.args[0].value
            work = next(k.value for k in node.keywords if k.arg == "work")
            keys = {k.arg for k in work.keywords}
            params = inspect.signature(getattr(costs, kernel)).parameters
            required = {n for n, p in params.items() if p.default is inspect.Parameter.empty}
            assert required <= keys <= set(params), (kernel, keys)
            seen.add(kernel)
    assert seen == set(costs._BY_KERNEL)
    launch = engine.Launch("fused_engine", {}, "mma", 1, None,
                           dict(B=2, ty=3, tx=3, N=8, M=4, inv=np.ones((9, 4)), sub_slices=((0, 9),), cells=10,
                                out=12))
    assert costs.of_launch(launch).products == 2 * 18 * 9 * 8 * 4
