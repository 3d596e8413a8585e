"""The forward tensor-core core (``csrc/fwd_core.cuh``) on the CPU.

The 1D engine's ``engine1d_mma_kernel`` (TPU kernels 8/9) runs on the card
only; here a numpy model of the core's addressing, read off the CUDA
formulas (``put_a``, ``mma_fold``'s fragment loads, ``out_tile`` /
``out_m``, the kernel's pass ends), is held against the plain forward:

* ``engine._fwd_passes``: every pass holds at most the kernel's positions
  and sub-filters, and maps each packed position to the slot its Winograd
  position was formed in;
* a block's warps and lanes cover every (tile, output channel) exactly
  once, each mma reads the A and B entries of one input channel per k step
  and every channel of a chunk once, and the passes cover every packed
  position once;
* the in-register fold of every k step's products, over the passes in
  order, gives the plain forward (each sub-filter's outputs, stored once,
  carried into the next pass where the sub-filter runs on, empty
  sub-filters as zeros), and a sub-filter split over two passes adds up to
  the same sums as one pass;
* the plain forward versions the card holds the forward kernels against,
  against JAX's ``conv1d_engine_ref`` and, at the conv corner,
  ``winograd_conv_fused_engine`` (Pallas, interpret mode).

Shapes: the audio decoder's K4S2 deconv1d (6 positions on 3 Winograd
positions), the F(2,4) conv1d K4 (n = 5) and the F(2,3) K3, K6S3 (3
sub-filters: two passes), K3S2 and K5S2 with output padding, K2S3 (an empty
sub-filter), K4S4 (4 sub-filters of 3: two passes) and phases=2; at the
conv corner the smoke's ragged shape
(``chip_smoke.CONV_RAGGED_SHAPE``: K4S2, batch 7, 11x11, 100 -> 36, T =
63), K3S1, K3S2 at an odd extent and K5S2.  Tolerance ``1e-4 * max|plain| +
1e-5``, the smoke's for kernel against plain; the model runs in float64.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import tdc as jtdc
from repro.core.winograd import get_transform as jget_transform
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import winograd_deconv as jwd
from repro_torch.core import DeconvDims, conv_same_dims
from repro_torch.core.winograd import get_transform
from repro_torch.kernels import _build
from repro_torch.kernels import engine as E
from repro_torch.kernels import ops as tops


def _cores(source: str):
    """(WT, WM, FA, FB, PMAX, M2, SMAX) of each fwd::Core the source's configurations instantiate."""
    found = re.findall(r"fwd::Core<(\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (\d+), \d+>",
                       (_build.CSRC / source).read_text())
    assert found, source
    return [tuple(int(v) for v in m) for m in found]


CORES_1D = _cores("engine1d.cu")
# every instantiation shares its pass limits (PMAX, SMAX)
assert len({c[4:] for c in CORES_1D}) == 1
CORE_1D = CORES_1D[0]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-5)


# ------------------------------------------------------------ the addressing
def _fragment_maps(WT, WM, FA, FB):
    """The block's fragment addressing, as fwd_core.cuh computes it.

    Returns (out_tl, out_ml, a_tl, a_ch, b_n, b_ml), each (warps, 32 lanes,
    FA, FB, 4 entries[, 8 k]): the tile row and channel m of each output
    entry (out_tile / out_m), and for each of its mma's 8 k the tile row and
    input channel of the A entry it reads (put_a's store, read back in
    fragment order) and the input channel and channel m of the B entry
    (mma_fold's weight loads)."""
    BT = 16 * FA * WT
    # put_a: item (f, lane, e) writes A entries 2e and 2e + 1 of (f, lane): tiles 16f + gq (+ 8), channel 2tq + e
    a_src = np.full((BT // 16, 32, 4, 2), -1)
    for it in range(4 * BT):
        e, lane, f = it & 1, (it >> 1) & 31, it >> 6
        for h in range(2):
            a_src[f, lane, 2 * e + h] = (16 * f + (lane >> 2) + 8 * h, 2 * (lane & 3) + e)
    assert (a_src >= 0).all()
    nw = WT * WM
    shape = (nw, 32, FA, FB, 4)
    out_tl, out_ml = np.zeros(shape, int), np.zeros(shape, int)
    a_tl, a_ch, b_n, b_ml = (np.zeros(shape + (8,), int) for _ in range(4))
    for warp in range(nw):
        wt, wm = warp // WM, warp % WM
        for lane in range(32):
            gq, tq = lane >> 2, lane & 3
            for fa in range(FA):
                for fb in range(FB):
                    for j in range(4):
                        out_tl[warp, lane, fa, fb, j] = (wt * FA + fa) * 16 + gq + 8 * (j >> 1)
                        out_ml[warp, lane, fa, fb, j] = (wm * FB + fb) * 8 + 2 * tq + (j & 1)
                        row, col = gq + 8 * (j >> 1), 2 * tq + (j & 1)  # the entry in mma's D
                        for k in range(8):
                            # m16n8k8: A (row, k) is a0..a3 of lane 4(row % 8) + k % 4; B (k, col) b0 / b1 of lane
                            # 4col + k % 4, which mma_fold reads as ww[n = 2(k % 4) + (k >= 4)][m = 8(wm*FB + fb) + col]
                            la, ia = 4 * (row % 8) + k % 4, (row >= 8) + 2 * (k >= 4)
                            lb = 4 * col + k % 4
                            a_tl[warp, lane, fa, fb, j, k], a_ch[warp, lane, fa, fb, j, k] = a_src[wt * FA + fa, la, ia]
                            b_n[warp, lane, fa, fb, j, k] = 2 * (lb & 3) + (k >= 4)
                            b_ml[warp, lane, fa, fb, j, k] = (wm * FB + fb) * 8 + (lb >> 2)
    return out_tl, out_ml, a_tl, a_ch, b_n, b_ml


@pytest.mark.parametrize("core", CORES_1D, ids=[f"rank1_{i}" for i in range(len(CORES_1D))])
def test_fragments_cover_each_output_once_and_pair_one_channel_a_k_step(core):
    WT, WM, FA, FB = core[:4]
    out_tl, out_ml, a_tl, a_ch, b_n, b_ml = _fragment_maps(WT, WM, FA, FB)
    # every (tile row, channel m) of the block held by exactly one lane entry
    cover = np.zeros((16 * FA * WT, 8 * FB * WM), int)
    np.add.at(cover, (out_tl.ravel(), out_ml.ravel()), 1)
    assert (cover == 1).all()
    # each product of an entry's mma: A of its own tile, B of its own channel m, both of one input channel
    np.testing.assert_array_equal(a_tl, out_tl[..., None].repeat(8, -1))
    np.testing.assert_array_equal(b_ml, out_ml[..., None].repeat(8, -1))
    np.testing.assert_array_equal(a_ch, b_n)
    # the k step's 8 input channels, each once
    np.testing.assert_array_equal(np.sort(a_ch, axis=-1), np.broadcast_to(np.arange(8), a_ch.shape))


def _check_passes(pos_q, subs, pmax, smax):
    """The plan's invariants; returns its arrays."""
    plan, npass, nslot, npos = E._fwd_passes(tuple(pos_q), tuple(subs), pmax, smax)
    C = len(pos_q)
    assert len(plan) == npass + 1 + npass * smax + 2 * C + 16 * npass
    off = plan[: npass + 1]
    psub = np.asarray(plan[npass + 1 : npass + 1 + npass * smax]).reshape(npass, smax)
    i0 = npass + 1 + npass * smax
    isub, islot = plan[i0 : i0 + C], plan[i0 + C : i0 + 2 * C]
    qslot = np.asarray(plan[i0 + 2 * C :]).reshape(npass, 16)
    sub_of = [s for s, (lo, hi) in enumerate(subs) for _ in range(lo, hi)]
    assert off[0] == 0 and off[-1] == C and all(a < b for a, b in zip(off, off[1:]))
    for k in range(npass):
        lo, hi = off[k], off[k + 1]
        assert hi - lo <= pmax and hi - lo <= npos
        used = qslot[k][qslot[k] >= 0]
        assert sorted(used) == list(range(len(used))) and len(used) <= nslot
        held = [s for s in psub[k] if s >= 0]
        assert held == sorted(set(sub_of[lo:hi])) and len(held) <= smax
        for p in range(lo, hi):  # the slot read for position p is where its Winograd position was formed
            assert qslot[k][pos_q[p]] == islot[p] and held[isub[p]] == sub_of[p]
    return off, psub, isub, islot, qslot


def _conv_case(K, S, B, H, W, N, M, seed=0):
    rng = np.random.default_rng(seed)
    cd = conv_same_dims(K, S, H)
    x = rng.standard_normal((B, H, W, N)).astype(np.float32)
    w = (0.5 / (K * N**0.5) * rng.standard_normal((K, K, N, M))).astype(np.float32)
    packed = tops.prepack_conv(torch.from_numpy(w), cd)
    cells = tops.conv_cells_from_image(torch.from_numpy(x), cd)
    pos = tops.conv_packed_layout(cd)[0]
    HO, WO = cd.out_size(H), cd.out_size(W)
    return dict(x=x, w=w, cells=cells, ww=packed.ww, inv=packed.inv, pos=pos, ty=-(-HO // 2), tx=-(-WO // 2),
                HO=HO, WO=WO, s2=S * S, K=K, S=S, H=H, W=W)


def _conv_shapes():
    name, K, S, B, H, W, N, M = chip_smoke.CONV_RAGGED_SHAPE[:8]
    assert B * -(-conv_same_dims(K, S, H).out_size(H) // 2) * -(-conv_same_dims(K, S, W).out_size(W) // 2) == 63
    return {name: (K, S, B, H, W, N, M), "k3s1": (3, 1, 2, 9, 9, 12, 20), "k3s2_odd": (3, 2, 2, 9, 9, 16, 24),
            "k5s2": (5, 2, 1, 10, 10, 8, 16)}


CONV_SHAPES = _conv_shapes()


@pytest.mark.parametrize("name", list(CONV_SHAPES))
def test_conv_plain_forward_matches_jax_pallas_interpret(name):
    """The plain version the card holds the kernel against, against the
    reference's ``winograd_conv_fused_engine`` in interpret mode (cells
    mode, with bias and leaky_relu) at the same shape."""
    c = _conv_case(*CONV_SHAPES[name], seed=1)
    M = c["ww"].shape[2]
    bias = np.linspace(-0.2, 0.2, M).astype(np.float32)
    jd = jtdc.conv_same_dims(c["K"], c["S"], c["H"])
    jp = jops.prepack_conv(jnp.asarray(c["w"]), jd)
    jcells = jops.conv_cells_from_image(jnp.asarray(c["x"]), jd)
    bt = tuple(tuple(float(v) for v in row) for row in jget_transform(2, 3).BT)
    geo = dict(pos_idx=c["pos"], m=2, n=4, ty=c["ty"], tx=c["tx"], s2=c["s2"])
    want = jwd.winograd_conv_fused_engine(jcells, jp.ww, jp.inv, bt, interpret=True, out_mode="cells",
                                          activation="leaky_relu", bias=jnp.asarray(bias), out_h=c["HO"],
                                          out_w=c["WO"], **jops.INTERPRET_BLOCKS_CONV, **geo)
    got = E.conv_fused_engine_plain(c["cells"], c["ww"], c["inv"], out_mode="cells", activation="leaky_relu",
                                    bias=torch.from_numpy(bias), out_h=c["HO"], out_w=c["WO"], **geo)
    _close(got.numpy(), np.asarray(want)[..., :M])


# ---------------------------------------------------------------- rank 1
def _case_1d(kind, geo, B=2, L=40, N=12, M=20, seed=0):
    rng = np.random.default_rng(seed)
    bt23 = tuple(tuple(float(v) for v in row) for row in get_transform(2, 3).BT)
    if kind == "deconv":
        w = (0.05 * rng.standard_normal((geo.kernel, N, M))).astype(np.float32)
        packed = tops.prepack_deconv1d(torch.from_numpy(w), geo)
        cells, ty = tops.deconv1d_cells_from_seq(torch.from_numpy(rng.standard_normal((B, L, N)).astype(np.float32)),
                                                 geo)
        pos, subs, _, _ = tops.packed_deconv1d_layout(geo)
        return dict(cells=cells, ww=packed.ww, inv=packed.inv, bt=bt23, pos=pos, subs=subs, ty=ty, n=4, phases=1)
    if kind == "conv":
        w = (0.05 * rng.standard_normal((geo, N, M))).astype(np.float32)
        packed = tops.prepack_conv1d(torch.from_numpy(w), geo)
        cells, ty, _ = tops.conv1d_cells_from_seq(torch.from_numpy(rng.standard_normal((B, L, N)).astype(np.float32)),
                                                  geo, padding="causal")
        pos, subs, _, bt, n = tops.conv1d_layout(geo)
        return dict(cells=cells, ww=packed.ww, inv=packed.inv, bt=bt, pos=pos, subs=subs, ty=ty, n=n, phases=1)
    ty, C = L, 4 * geo  # one sub-filter over `geo` phases of F(2,3) positions, as a strided conv lays them out
    return dict(cells=torch.from_numpy(rng.standard_normal((B, ty + 1, 2 * geo, N)).astype(np.float32)),
                ww=torch.from_numpy((0.05 * rng.standard_normal((C, N, M))).astype(np.float32)),
                inv=torch.as_tensor(np.tile(tops.conv1d_layout(3)[2], (geo, 1))), bt=bt23, pos=tuple(range(C)),
                subs=((0, C),), ty=ty, n=4, phases=geo)


SHAPES_1D = {"audio_k4s2": ("deconv", DeconvDims(4, 2, 1, 0)), "conv1d_k4": ("conv", 4),
             "conv1d_k3": ("conv", 3), "k6s3": ("deconv", DeconvDims(6, 3, 2, 0)),
             "k3s2_op1": ("deconv", DeconvDims(3, 2, 1, 1)), "k5s2_op1": ("deconv", DeconvDims(5, 2, 2, 1)),
             "k2s3": ("deconv", DeconvDims(2, 3, 0, 0)), "k4s4": ("deconv", DeconvDims(4, 4, 0, 0)),
             "phases2": ("phases", 2)}


def _model_1d(c, pmax, smax):
    """The 1D kernel's sums in float64, with its pass ends: every k step's
    products fold into the outputs of their sub-filter's slot; at a pass's
    end a sub-filter whose last position was in it is stored (once), one that
    runs on moves to slot 0; empty sub-filters: zeros.  Returns the scratch
    layout (B, ty, S2*2, M)."""
    cells, ww, inv = (np.asarray(c[k], np.float64) for k in ("cells", "ww", "inv"))
    pos, subs, ty, n, phases = c["pos"], c["subs"], c["ty"], c["n"], c["phases"]
    B, N, M, S2 = cells.shape[0], cells.shape[3], ww.shape[2], len(subs)
    off, psub, isub, islot, qslot = _check_passes(list(pos), subs, pmax, smax)
    bt = np.asarray(c["bt"], np.float64)
    q = -(-n // 2)
    z = np.zeros((B, ty, phases, n, N))  # tile j of phase s: z[u] = cell row j + u//2, sub-row 2s + u%2
    for s in range(phases):
        for u in range(n):
            z[:, :, s, u] = cells[:, u // 2 : u // 2 + ty, 2 * s + u % 2]
    assert cells.shape[1] >= ty + q - 1
    xw = np.einsum("vu,bjsun->bjsvn", bt, z).reshape(B, ty, phases * n, N)
    out = np.full((B, ty, S2, 2, M), np.nan)
    y = np.zeros((smax, B, ty, 2, M))
    sub_off = [lo for lo, _ in subs] + [subs[-1][1]]
    for k in range(len(off) - 1):
        lo, hi = off[k], off[k + 1]
        slots = {int(sl): qq for qq, sl in enumerate(qslot[k]) if sl >= 0}
        for n0 in range(0, N, 8):  # the k steps in order, each position's products folded
            for p in range(lo, hi):
                y[isub[p]] += inv[p][:, None] * (xw[..., slots[islot[p]], n0 : n0 + 8] @ ww[p, n0 : n0 + 8])[..., None, :]
        for j, s in enumerate(psub[k]):  # the kernel's pass_end
            if s < 0:
                continue
            if sub_off[s + 1] <= hi:
                assert np.isnan(out[:, :, s]).all(), "a sub-filter is stored once"
                out[:, :, s], y[j] = y[j], 0.0
            elif j > 0:
                y[0], y[j] = y[j], 0.0
    for s in range(S2):
        if sub_off[s] == sub_off[s + 1]:
            out[:, :, s] = 0.0
    assert not np.isnan(out).any()
    return out.reshape(B, ty, S2 * 2, M)


@pytest.mark.parametrize("name", list(SHAPES_1D))
def test_rank1_model_folds_to_the_plain_forward(name):
    c = _case_1d(*SHAPES_1D[name])
    kw = dict(pos_idx=c["pos"], sub_slices=c["subs"], m=2, n=c["n"], ty=c["ty"], phases=c["phases"])
    want = E.winograd_conv1d_fused_engine_plain(c["cells"], c["ww"], c["inv"], c["bt"], out_mode="scratch", **kw)
    _close(_model_1d(c, CORE_1D[4], CORE_1D[6]), want.numpy())


def test_rank1_passes_of_the_decoder_and_the_longer_layouts():
    """The decoder's 6 positions of 2 sub-filters run in one pass on its 3
    Winograd positions; K6S3's 3 sub-filters in two passes (the kernel holds
    2 a pass)."""
    got = {}
    for name in ("audio_k4s2", "k6s3", "phases2", "conv1d_k4"):
        c = _case_1d(*SHAPES_1D[name])
        _, npass, nslot, npos = E._fwd_passes(tuple(c["pos"]), tuple(c["subs"]), CORE_1D[4], CORE_1D[6])
        got[name] = (npass, nslot, npos)
    assert got == {"audio_k4s2": (1, 3, 6), "k6s3": (2, 3, 6), "phases2": (1, 8, 8), "conv1d_k4": (1, 5, 5)}


def test_rank1_sub_filter_split_over_passes_carries_its_outputs():
    """Two sub-filters of 4 and 8 positions (3 phases of F(2,3)): the first
    pass holds 4 + 5, the second sub-filter's outputs run on into the next
    pass as its slot 0 and are stored once, as one pass would."""
    rng = np.random.default_rng(5)
    B, ty, N, M = 2, 9, 16, 8
    c = dict(cells=torch.from_numpy(rng.standard_normal((B, ty + 1, 6, N)).astype(np.float32)),
             ww=torch.from_numpy((0.1 * rng.standard_normal((12, N, M))).astype(np.float32)),
             inv=torch.from_numpy(rng.standard_normal((12, 2)).astype(np.float32)),
             bt=tuple(tuple(float(v) for v in row) for row in get_transform(2, 3).BT), pos=tuple(range(12)),
             subs=((0, 4), (4, 12)), ty=ty, n=4, phases=3)
    off = _check_passes(list(c["pos"]), c["subs"], CORE_1D[4], CORE_1D[6])[0]
    assert off == (0, 9, 12)
    kw = dict(pos_idx=c["pos"], sub_slices=c["subs"], m=2, n=4, ty=ty, phases=3)
    want = E.winograd_conv1d_fused_engine_plain(c["cells"], c["ww"], c["inv"], c["bt"], out_mode="scratch", **kw)
    _close(_model_1d(c, CORE_1D[4], CORE_1D[6]), want.numpy())
    np.testing.assert_allclose(_model_1d(c, CORE_1D[4], CORE_1D[6]), _model_1d(c, 16, 2), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", list(SHAPES_1D))
def test_rank1_plain_forward_matches_jax_ref(name):
    c = _case_1d(*SHAPES_1D[name], seed=2)
    kw = dict(pos_idx=c["pos"], sub_slices=c["subs"], m=2, n=c["n"], ty=c["ty"], phases=c["phases"])
    stride = len(c["subs"]) if SHAPES_1D[name][0] == "deconv" else 1
    j = lambda a: jnp.asarray(np.asarray(a))  # noqa: E731
    want = jref.conv1d_engine_ref(j(c["cells"]), j(c["ww"]), j(c["inv"]), c["bt"], stride=stride, **kw)
    got = E.winograd_conv1d_fused_engine_plain(c["cells"], c["ww"], c["inv"], c["bt"], out_mode="nlc", stride=stride,
                                               **kw)
    _close(got.numpy(), np.asarray(want))
