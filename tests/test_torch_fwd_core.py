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
  ``winograd_conv_fused_engine`` (Pallas, interpret mode);
* the two 2D kernels on the core, TPU kernel 3 at both corners
  (``conv_engine.cu::conv_fwd_mma_kernel``, ``fused_engine.cu::
  fused_epi_mma_kernel``): a model of their block layout (each tile's 4x4
  cell window as ``fwd::stage_windows`` reads it, B^T Z B as
  ``fwd::prep_windows`` forms it, passes of one phase or sub-filter, the
  conv corner's passes split over blocks and summed in split order, the
  deconv corner's block finding its sub-filter's passes, every out mode's
  store) against the plain forward and JAX's ``conv_engine_ref`` /
  ``fused_epilogue_engine_ref`` / ``fused_pre_engine_ref``.

Shapes: the audio decoder's K4S2 deconv1d (6 positions on 3 Winograd
positions), the F(2,4) conv1d K4 (n = 5) and the F(2,3) K3, K6S3 (3
sub-filters: two passes), K3S2 and K5S2 with output padding, K2S3 (an empty
sub-filter), K4S4 (4 sub-filters of 3: two passes) and phases=2; at the
conv corner the smoke's ragged shape
(``chip_smoke.CONV_RAGGED_SHAPE``: K4S2, batch 7, 11x11, 100 -> 36, T =
63), K3S1, K3S2 at an odd extent and K5S2; at the deconv corner DCGAN's
K5S2 (sub-filters of 16, 12, 12 and 9 packed positions: two passes for
all but the last), the smoke's ragged shape (``chip_smoke.RAGGED_SHAPE``),
K4S2 and K2S3 (empty sub-filters).  Tolerance ``1e-4 * max|plain| +
1e-5``, the smoke's for kernel against plain; the models run in float64.
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
CORES_2D = {"conv": _cores("conv_engine.cu"), "deconv": _cores("fused_engine.cu")}
# every instantiation of a kernel shares its pass limits (PMAX, M2, SMAX): one group a pass at the 2D corners
assert len({c[4:] for c in CORES_1D}) == 1 and all(len({c[4:] for c in v}) == 1 for v in CORES_2D.values())
CORE_1D = CORES_1D[0]
PMAX_2D = {k: v[0][4] for k, v in CORES_2D.items()}
assert all(v[0][5:] == (4, 1) for v in CORES_2D.values())


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


_ALL_CORES = CORES_1D + CORES_2D["conv"] + CORES_2D["deconv"]
_CORE_IDS = [f"rank1_{i}" for i in range(len(CORES_1D))] + [f"{k}_{i}" for k in ("conv", "deconv")
                                                             for i in range(len(CORES_2D[k]))]


@pytest.mark.parametrize("core", _ALL_CORES, ids=_CORE_IDS)
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


# ------------------------------------------------------ the 2D kernels' blocks
def _windows(cells, ty, tx, s):
    """Every tile's 4x4 window of phase s, (T, 16, N), as fwd::stage_windows
    copies it: entry 4a + c from cell (jy + a // 2, jx + c // 2), sub-cell
    (a % 2) * 2 + c % 2 of the phase's four channel slots."""
    B, Gy, Gx, cs, N = cells.shape
    b, rm = np.divmod(np.arange(B * ty * tx), ty * tx)
    jy, jx = np.divmod(rm, tx)
    base = (b * Gy + jy) * Gx + jx
    flat = cells.reshape(B * Gy * Gx, cs, N)
    return np.stack([flat[base + (a // 2) * Gx + c // 2, s * 4 + (a % 2) * 2 + c % 2]
                     for a in range(4) for c in range(4)], axis=1)


def _prep(z):
    """xw (T, 16, N) as fwd::prep_windows forms it: B^T Z once a window
    (bt_rows), then each position's entry of that times B (b_col)."""
    z = z.reshape(len(z), 4, 4, -1)
    r = np.stack([z[:, 0] - z[:, 2], z[:, 1] + z[:, 2], z[:, 2] - z[:, 1], z[:, 1] - z[:, 3]], axis=1)
    x = np.stack([r[:, :, 0] - r[:, :, 2], r[:, :, 1] + r[:, :, 2], r[:, :, 2] - r[:, :, 1], r[:, :, 1] - r[:, :, 3]],
                 axis=2)
    return x.reshape(len(z), 16, -1)


def _fold(xw_of, ww, inv, plan, passes):
    """The tiles' 4 outputs (T, 4, M) over ``passes``: every k step's
    products of each position, folded through its inv row as they come, the
    A operand read from the slot its Winograd position was formed in."""
    off, psub, isub, islot, qslot = plan
    y = 0.0
    for k in passes:
        assert list(isub[off[k] : off[k + 1]]) == [0] * (off[k + 1] - off[k])  # one group a pass
        xw, slot_q = xw_of(psub[k][0]), {sl: q for q, sl in enumerate(qslot[k]) if sl >= 0}
        for n0 in range(0, ww.shape[1], 8):
            for p in range(off[k], off[k + 1]):
                y = y + inv[p][None, :, None] * (xw[:, slot_q[islot[p]], n0 : n0 + 8] @ ww[p, n0 : n0 + 8])[:, None]
    return y


def _act(v, act):
    return {"none": v, "relu": np.maximum(v, 0), "tanh": np.tanh(v),
            "leaky_relu": np.where(v >= 0, v, 0.2 * v)}[act]


def _conv_model(c, act, out_mode, splits, scale, bias):
    """conv_fwd_mma_kernel's sums: passes of one phase (at most PMAX
    positions), split into ``splits`` ranges [k npass / splits, (k + 1) npass
    / splits), each range's outputs from zero, summed in split order; the
    epilogue and the store of out_mode."""
    cells, ww, inv = (np.asarray(c[k], np.float64) for k in ("cells", "ww", "inv"))
    pos, s2, ty, tx = c["pos"], c["s2"], c["ty"], c["tx"]
    off = [sum(p // 16 < s for p in pos) for s in range(s2 + 1)]
    plan = _check_passes([p % 16 for p in pos], list(zip(off[:-1], off[1:])), PMAX_2D["conv"], 1)
    npass = len(plan[0]) - 1
    xw = {s: _prep(_windows(cells, ty, tx, s)) for s in range(s2)}
    y = 0.0
    for k in range(splits):  # the last block's sum, in split order
        y = y + _fold(xw.__getitem__, ww, inv, plan, range(k * npass // splits, (k + 1) * npass // splits))
    B, M = cells.shape[0], ww.shape[2]
    v = _act(y * (1.0 if scale is None else scale) + bias, act)  # (T, 4, M): pixel (2jy + a // 2, 2jx + a % 2)
    img = v.reshape(B, ty, tx, 2, 2, M).transpose(0, 1, 3, 2, 4, 5).reshape(B, 2 * ty, 2 * tx, M)
    if out_mode == "nhwc":
        return img[:, : c["HO"], : c["WO"]]
    img[:, c["HO"] :], img[:, :, c["WO"] :] = 0.0, 0.0
    return img.reshape(B, ty, 2, tx, 2, M).transpose(0, 1, 3, 2, 4, 5).reshape(B, ty, tx, 4, M)


_CONV_MODEL_CASES = [(name, act, mode, splits) for name, act, mode in (
    (chip_smoke.CONV_RAGGED_SHAPE[0], "relu", "cells"), ("k3s1", "leaky_relu", "nhwc"), ("k5s2", "tanh", "cells"))
    for splits in (1, 2, 4)]


@pytest.mark.parametrize("name,act,mode,splits", _CONV_MODEL_CASES)
def test_conv_block_model_matches_the_plain_forward_and_jax(name, act, mode, splits):
    c = _conv_case(*CONV_SHAPES[name], seed=4)
    M = c["ww"].shape[2]
    rng = np.random.default_rng(5)
    scale, bias = (1 + 0.1 * rng.standard_normal(M)).astype(np.float32), (0.1 * rng.standard_normal(M)).astype(np.float32)
    geo = dict(pos_idx=c["pos"], m=2, n=4, ty=c["ty"], tx=c["tx"], s2=c["s2"])
    got = _conv_model(c, act, mode, splits, scale, bias)
    want = E.conv_fused_engine_plain(c["cells"], c["ww"], c["inv"], out_mode=mode, activation=act,
                                     scale=torch.from_numpy(scale), bias=torch.from_numpy(bias), out_h=c["HO"],
                                     out_w=c["WO"], **geo)
    _close(got, want.numpy())
    bt = tuple(tuple(float(v) for v in row) for row in jget_transform(2, 3).BT)
    j = lambda a: jnp.asarray(np.asarray(a))  # noqa: E731
    jw = jref.conv_engine_ref(j(c["cells"]), j(c["ww"]), j(c["inv"]), bt, j(scale), j(bias), out_mode=mode,
                              activation=act, out_h=c["HO"], out_w=c["WO"], **geo)
    jw = np.asarray(jw)
    _close(got, jw[:, : c["HO"], : c["WO"]] if mode == "nhwc" else jw)
    if splits > 1:  # the split changes only the order of the sums
        np.testing.assert_allclose(got, _conv_model(c, act, mode, 1, scale, bias), rtol=1e-12, atol=1e-12)


def test_conv_passes_hold_one_phase_each():
    """K4S2's 36 positions: a pass a phase (9 positions on 9 Winograd
    positions); K5S2's 49: 16 / 12 / 12 / 9 by phase, 7 passes."""
    got = {}
    for name in (chip_smoke.CONV_RAGGED_SHAPE[0], "k5s2", "k3s1"):
        pos, s2 = _conv_case(*CONV_SHAPES[name])["pos"], CONV_SHAPES[name][1] ** 2
        off = [sum(p // 16 < s for p in pos) for s in range(s2 + 1)]
        plan, npass, nslot, npos = E._fwd_passes(tuple(p % 16 for p in pos), tuple(zip(off[:-1], off[1:])),
                                                 PMAX_2D["conv"], 1)
        got[name] = (off, npass, nslot, npos)
    assert got == {chip_smoke.CONV_RAGGED_SHAPE[0]: ([0, 9, 18, 27, 36], 4, 9, 9),
                   "k5s2": ([0, 16, 28, 40, 49], 7, 9, 9), "k3s1": ([0, 16], 2, 9, 9)}


def _deconv_case(dims, B, H, N, M, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, H, N)).astype(np.float32)
    w = (0.05 * rng.standard_normal((dims.kernel, dims.kernel, N, M))).astype(np.float32)
    packed = tops.prepack(torch.from_numpy(w), dims)
    pos, subs, _, _ = tops.packed_layout(dims)
    return dict(cells=tops.cells_from_image(torch.from_numpy(x), dims), ww=packed.ww, inv=packed.inv, pos=pos,
                subs=subs, ty=-(-dims.j_extent(H) // 2), S=dims.stride, P=dims.padding, HO=dims.out_size(H))


def _deconv_model(c, act, out_mode, scale, bias):
    """fused_epi_mma_kernel's sums: passes of one sub-filter (at most PMAX
    positions); the block of sub-filter s runs passes [p0, p1), p0 those
    ending at or before its first position, p1 those starting before its
    end (an empty sub-filter: none, its outputs zero); the epilogue and the
    depth-to-space store of out_mode."""
    cells, ww, inv = (np.asarray(c[k], np.float64) for k in ("cells", "ww", "inv"))
    subs, ty, S, P, HO = c["subs"], c["ty"], c["S"], c["P"], c["HO"]
    plan = _check_passes(list(c["pos"]), subs, PMAX_2D["deconv"], 1)
    off, psub = plan[0], plan[1]
    xw = _prep(_windows(cells, ty, ty, 0))
    B, M, T = cells.shape[0], ww.shape[2], len(xw)
    y = np.zeros((T, S * S, 4, M))
    for s, (lo, hi) in enumerate(subs):
        p0 = sum(off[p + 1] <= lo for p in range(len(off) - 1))
        p1 = sum(off[p] < hi for p in range(len(off) - 1))
        assert [k for k in range(len(off) - 1) if psub[k][0] == s] == list(range(p0, p1))
        y[:, s] = _fold(lambda _: xw, ww, inv, plan, range(p0, p1))
    if out_mode == "scratch":
        return y.reshape(B, ty, ty, S * S * 4, M)
    v = _act(y * (1.0 if scale is None else scale) + (0.0 if bias is None else bias), act)
    # sub-pixel (ry, rx, a // 2, a % 2) of tile (jy, jx): pixel (2S jy + S (a // 2) + ry, 2S jx + S (a % 2) + rx)
    img = v.reshape(B, ty, ty, S, S, 2, 2, M).transpose(0, 1, 5, 3, 2, 6, 4, 7).reshape(B, 2 * S * ty, 2 * S * ty, M)
    if out_mode == "nhwc":
        return img[:, P : P + HO, P : P + HO]
    keep = (np.arange(2 * S * ty) >= P) & (np.arange(2 * S * ty) < P + HO)
    img = np.where(keep[None, :, None, None] & keep[None, None, :, None], img, 0.0)
    return img.reshape(B, S * ty, 2, S * ty, 2, M).transpose(0, 1, 3, 2, 4, 5).reshape(B, S * ty, S * ty, 4, M)


_DECONV_MODEL_CASES = {
    "dcgan_k5s2": ((5, 2, 2, 1), 2, 5, 12, 24, "relu", "cells"),
    "ragged": (chip_smoke.RAGGED_SHAPE[1], *chip_smoke.RAGGED_SHAPE[2:], "relu", "cells"),
    "k5s2_nhwc": ((5, 2, 2, 1), 2, 4, 8, 16, "tanh", "nhwc"),
    "k5s2_scratch": ((5, 2, 2, 1), 2, 4, 8, 16, "none", "scratch"),
    "k4s2": ((4, 2, 1, 0), 2, 6, 8, 16, "leaky_relu", "cells"),
    "k2s3_empty": ((2, 3, 0, 0), 2, 5, 8, 16, "relu", "nhwc"),
}


@pytest.mark.parametrize("name", list(_DECONV_MODEL_CASES))
def test_deconv_block_model_matches_the_plain_forward_and_jax(name):
    geo, B, H, N, M, act, mode = _DECONV_MODEL_CASES[name]
    c = _deconv_case(DeconvDims(*geo), B, H, N, M, seed=6)
    rng = np.random.default_rng(7)
    affine = mode != "scratch"
    scale = (1 + 0.1 * rng.standard_normal(M)).astype(np.float32) if affine else None
    bias = (0.1 * rng.standard_normal(M)).astype(np.float32) if affine else None
    got = _deconv_model(c, act, mode, scale, bias)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    kw = dict(pos_idx=c["pos"], sub_slices=c["subs"], m=2, n=4, ty=c["ty"], tx=c["ty"])
    want = E.fused_engine_plain(c["cells"], c["ww"], c["inv"], out_mode=mode, activation=act, scale=t(scale),
                                bias=t(bias), stride=c["S"], padding=c["P"], out_h=c["HO"], out_w=c["HO"], **kw)
    _close(got, want.numpy())
    bt = tuple(tuple(float(v) for v in row) for row in jget_transform(2, 3).BT)
    j = lambda a: None if a is None else jnp.asarray(np.asarray(a))  # noqa: E731
    if mode == "scratch":
        jw = jref.fused_pre_engine_ref(j(c["cells"]), j(c["ww"]), j(c["inv"]), bt, m2=4, **kw)
    else:
        jw = jref.fused_epilogue_engine_ref(j(c["cells"]), j(c["ww"]), j(c["inv"]), bt, j(scale), j(bias), m2=4,
                                            out_mode=mode, activation=act, stride=c["S"], padding=c["P"],
                                            out_h=c["HO"], out_w=c["HO"], **kw)
    jw = np.asarray(jw)
    if mode == "nhwc":
        jw = jw[:, c["P"] : c["P"] + c["HO"], c["P"] : c["P"] + c["HO"]]
    _close(got, jw.reshape(got.shape))


def test_deconv_passes_of_dcgan_and_an_empty_sub_filter():
    """DCGAN's K5S2: 16 / 12 / 12 / 9 positions by sub-filter, 2 / 2 / 2 / 1
    passes; K2S3's 9 sub-filters hold 4 / 2 / 0 / ...: its empty ones none."""
    c = _deconv_case(DeconvDims(5, 2, 2, 1), 1, 4, 8, 8)
    assert [hi - lo for lo, hi in c["subs"]] == [16, 12, 12, 9]
    off, psub = _check_passes(list(c["pos"]), c["subs"], PMAX_2D["deconv"], 1)[:2]
    assert [int(ps[0]) for ps in psub] == [0, 0, 1, 1, 2, 2, 3] and len(off) == 8
    c = _deconv_case(DeconvDims(2, 3, 0, 0), 1, 4, 8, 8)
    sizes = [hi - lo for lo, hi in c["subs"]]
    assert 0 in sizes
    psub = _check_passes(list(c["pos"]), c["subs"], PMAX_2D["deconv"], 1)[1]
    assert sorted({int(ps[0]) for ps in psub}) == [s for s, n in enumerate(sizes) if n]
