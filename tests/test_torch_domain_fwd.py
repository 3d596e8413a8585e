"""TPU kernel 1's redesigned forward (``csrc/domain_engine.cu``) on the CPU.

The two new instantiations run on the card only; here numpy models read
off the CUDA formulas are held against ``domain_engine_plain`` and JAX's
``engine_ref`` oracle (its plain ref path):

* ``domain_fwd_mma_kernel`` (wgmma with TMA): its block geometry (the
  ``tcf`` constants), the 128-byte swizzle that TMA writes and ``a_off`` /
  the B descriptor read back, the wgmma register fragments of A and of the
  accumulator (every tile row and channel of a block stored once, every A
  entry read once a k-step), the grid order (sub-filters by packed
  positions, heaviest first; every (sub-filter, M tile, T tile) once), and
  the block loop itself: position-outer, the whole N loop in stages of 32
  channels, 3xTF32 products (``split_tf32``'s halves, lo read as TF32),
  chains of ``kFwdChain`` stages summed with truncating fp32 adds (the
  tensor cores') and folded into the 4 outputs through inv with rounded
  fp32 adds (the chain's start and end conditions read from the source;
  folds that drop or repeat a chain fail), the ragged T, N and M edges
  zero-filled as TMA fills them;
* ``domain_fwd_pack_kernel``: the (2, C, M, N) layout of ww's hi and lo
  halves that the B tensor map reads, exact in sum;
* ``domain_fwd_few_kernel``: blocks of 64 tiles x 4 channels, (tile,
  sub-filter) items uniform in sub-filter per warp, each position's dot
  product over chunks of BN channels n, folded through inv once at the end;
  its shared-memory strides free of bank conflicts.

Cases: DCGAN's K5S2 (sub-filters of 16, 12, 12, 9), K4S2, K3S1, K2S3 (empty
sub-filters) and the smoke's ragged shape (``chip_smoke.RAGGED_SHAPE``: K5S2,
batch 7, 11x11, 100 -> 36).  Tolerance ``1e-4 * max|plain| + 1e-5``, the
smoke's for kernel against plain.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import ref as jref
from repro_torch.core import DeconvDims
from repro_torch.core.winograd_deconv import pad_input_for_tiles, transform_input_tiles
from repro_torch.kernels import _build
from repro_torch.kernels import engine as E
from repro_torch.kernels import ops as tops

SRC = (_build.CSRC / "domain_engine.cu").read_text()
GEOMS = {"k5s2": (5, 2, 2, 1), "k4s2": (4, 2, 1, 0), "k3s1": (3, 1, 1, 0), "k2s3": (2, 3, 0, 0)}


def _consts(ns: str) -> dict:
    """The ``constexpr int`` constants of namespace ``ns`` in the source."""
    body = SRC[SRC.index(f"namespace {ns} {{"):]
    body = body[:body.index(f"}}  // namespace {ns}")]
    vals = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", body):
        # the source's own integer arithmetic
        vals[name] = eval(expr.replace("/", "//"), {}, dict(vals, kMaxPos=16, kMaxSub=16))  # noqa: S307
    return vals


TC, FC = _consts("tcf"), _consts("fcf")
CHAIN = int(re.search(r"constexpr int kFwdChain = (\d+);", SRC).group(1))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-5)


def test_block_geometry_read_from_the_source():
    assert (TC["BT"], TC["BM"], TC["BK"], TC["kThreads"]) == (128, 64, 32, 384)
    assert TC["BK"] * 4 == 128  # a stage's row is one 128-byte swizzle row: a TMA box of 32 fp32
    assert TC["kStage"] == TC["kA"] + 2 * TC["kB"] and TC["kA"] % 1024 == 0 and TC["kB"] % 1024 == 0
    assert (FC["BT"], FC["MC"], FC["kThreads"]) == (64, 4, 256) and FC["BN"] % 4 == 0 and FC["ST"] >= 2
    assert FC["TS"] % 32 == 4 and FC["TS"] % 4 == 0  # 16-byte aligned rows, 8 lanes on 8 bank groups
    assert CHAIN >= 1


# ------------------------------------------------------------ tensor cores
def _swizzle128(byte):
    """Physical byte of a logical byte offset in a 1024-byte-aligned tile
    that TMA writes in the 128-byte swizzle: bits 4-6 ^= bits 7-9."""
    byte = np.asarray(byte)
    return byte ^ (((byte >> 7) & 7) << 4)


def _a_off(r, c):
    """domain_engine.cu's tcf::a_off (words)."""
    return r * TC["BK"] + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3))


def _consumer_rows(warp, lane):
    """The kernel's r0 and cq of a consumer thread."""
    return (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2), lane & 3


def test_a_reads_are_the_tma_swizzle_and_the_wgmma_fragment_layout():
    r, c = np.meshgrid(np.arange(TC["BT"]), np.arange(TC["BK"]), indexing="ij")
    # a_off reads back the element TMA wrote for logical (row r, column c)
    assert np.array_equal(4 * _a_off(r, c), _swizzle128(r * 128 + c * 4))
    seen = np.zeros((TC["BT"], TC["BK"]), int)
    for warp in range(8):
        for lane in range(32):
            r0, cq = _consumer_rows(warp, lane)
            for ks in range(4):
                col = ks * 8 + cq
                # a[j] of the PTX m64nNk8 TF32 A fragment: row lane/4 (+8 for j odd), column lane%4 (+4 for j >= 2)
                for j, (rr, cc) in enumerate([(r0, col), (r0 + 8, col), (r0, col + 4), (r0 + 8, col + 4)]):
                    wg_row = 16 * (warp & 3) + (lane >> 2) + 8 * (j & 1)
                    assert rr == (warp >> 2) * 64 + wg_row and cc == ks * 8 + (lane & 3) + 4 * (j >> 1)
                    seen[rr, cc] += 1
    assert (seen == 1).all()  # every A entry of a stage read once, by its warpgroup
    # a warp's 32 lanes read 32 distinct banks for each fragment register
    for warp in range(8):
        for ks in range(4):
            for j in range(4):
                words = []
                for lane in range(32):
                    r0, cq = _consumer_rows(warp, lane)
                    words.append(_a_off(r0 + 8 * (j & 1), ks * 8 + cq + 4 * (j >> 1)))
                assert len({w % 32 for w in words}) == 32


def _desc_sw128(addr):
    return ((addr & 0x3FFFF) >> 4) | (1 << 16) | ((1024 >> 4) << 32) | (1 << 62)


def test_b_descriptor_reads_the_packed_rows_of_each_k_step():
    base = 3 * 1024  # any 1024-byte-aligned tile
    for ks in range(4):
        d = _desc_sw128(base) + 2 * ks  # the kernel's per-k-step advance
        start, sbo, layout = (d & 0x3FFF) << 4, ((d >> 32) & 0x3FFF) << 4, d >> 62
        assert (sbo, layout) == (1024, 1)
        for nn in range(TC["BM"]):
            for k in range(8):
                # K-major: 8-row groups SBO apart, rows of 128 bytes, a k-step 32 bytes along; then the swizzle
                phys = _swizzle128(start - base + (nn // 8) * sbo + (nn % 8) * 128 + 4 * k) + base
                # where TMA put logical (row m = nn, column n = 8ks + k) of the B box
                assert phys == base + _swizzle128(nn * 128 + 4 * (8 * ks + k))


def test_accumulator_fragments_store_every_output_once():
    seen = np.zeros((TC["BT"], TC["BM"]), int)
    for warp in range(8):
        for lane in range(32):
            r0, cq = _consumer_rows(warp, lane)
            for i in range(0, 32, 2):
                row, m = r0 + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * cq
                # the PTX accumulator layout of d[i] and d[i + 1]
                assert row == (warp >> 2) * 64 + 16 * (warp & 3) + (lane >> 2) + 8 * ((i % 4) >= 2)
                seen[row, m] += 1
                seen[row, m + 1] += 1
    assert (seen == 1).all()


def _sub_of_rank(offs, rank):
    """tcf::sub_of_rank."""
    S2 = len(offs) - 1
    cnt = [offs[u + 1] - offs[u] for u in range(S2)]
    s = 0
    for u in range(S2):
        r = sum(cnt[v] > cnt[u] or (cnt[v] == cnt[u] and v < u) for v in range(S2))
        if r == rank:
            s = u
    return s


def _offs(subs):
    return [lo for lo, _ in subs] + [subs[-1][1]]


@pytest.mark.parametrize("geom", list(GEOMS))
def test_grid_takes_the_heaviest_sub_filters_first_and_every_block_once(geom):
    _, subs, _, _ = tops.packed_layout(DeconvDims(*GEOMS[geom]))
    offs = _offs(subs)
    T, M = 300, 100
    n_tb, n_mb = -(-T // TC["BT"]), -(-M // TC["BM"])
    blocks = []
    for b in range(n_tb * n_mb * len(subs)):
        rank, rem = divmod(b, n_tb * n_mb)
        blocks.append((_sub_of_rank(offs, rank), rem // n_tb, rem % n_tb))
    assert sorted(blocks) == sorted({(s, mb, tb) for s in range(len(subs)) for mb in range(n_mb)
                                     for tb in range(n_tb)})
    counts = [offs[s + 1] - offs[s] for s, _, _ in blocks]
    assert counts == sorted(counts, reverse=True)
    if geom == "k5s2":
        assert sorted({c for c in counts}, reverse=True) == [16, 12, 9]


def _split_tf32(x):
    """bwd_x_core.cuh's split_tf32 on float32: hi rounded to TF32, lo the
    exact remainder; the tensor core reads lo's top 19 bits."""
    x = np.ascontiguousarray(x, np.float32)
    hi = ((x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    lo = (x - hi).astype(np.float32)
    return hi, (lo.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32), lo


def _pack(ww):
    """domain_fwd_pack_kernel: (C, N, M) -> (2, C, M, N), by its 32 x 32 tiles."""
    C, N, M = ww.shape
    wp = np.full((2, C, M, N), np.nan, np.float32)
    for p in range(C):
        for n0 in range(0, N, 32):
            for m0 in range(0, M, 32):
                tile = np.zeros((32, 33), np.float32)
                for ty in range(8):
                    for i in range(ty, 32, 8):
                        n, m = n0 + i, m0 + np.arange(32)
                        tile[i, :32] = np.where((n < N) & (m < M), ww[p, min(n, N - 1), np.minimum(m, M - 1)], 0)
                for ty in range(8):
                    for i in range(ty, 32, 8):
                        m, n = m0 + i, n0 + np.arange(32)
                        if m >= M:
                            continue
                        ok = n < N
                        hi, _, lo = _split_tf32(tile[np.arange(32), i])
                        wp[0, p, m, n[ok]] = hi[ok]
                        wp[1, p, m, n[ok]] = lo[ok]
    return wp


def test_pack_writes_each_weight_as_exact_tf32_halves():
    rng = np.random.default_rng(3)
    ww = rng.standard_normal((5, 40, 36)).astype(np.float32)
    wp = _pack(ww)
    assert not np.isnan(wp).any()  # every (half, p, m, n) written
    assert np.array_equal(wp[0] + wp[1], ww.transpose(0, 2, 1))  # hi + lo is the weight, exactly
    assert not (wp[0].view(np.uint32) & 0x1FFF).any()  # hi is TF32
    # the B tensor map over (N, M, 2C): box (32 n, 64 m, 1) at (n0, m0, p) and (n0, m0, C + p)
    flat = wp.reshape(2 * 5, 36, 40)
    assert np.array_equal(flat[2], wp[0, 2]) and np.array_equal(flat[5 + 2], wp[1, 2])


def _xw_case(geom, T, N, M, seed):
    pos, subs, inv, _ = tops.packed_layout(DeconvDims(*GEOMS[geom]))
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((T, 16, N)).astype(np.float32)
    ww = (0.1 * rng.standard_normal((len(pos), N, M))).astype(np.float32)
    return xw, ww, np.asarray(inv, np.float32), dict(pos_idx=pos, sub_slices=subs, m2=4)


def _ragged_case(seed=0):
    """The smoke's ragged shape (K5S2, batch 7, 11x11, 100 -> 36): xw from the image."""
    _, k, B, H, N, M = chip_smoke.RAGGED_SHAPE
    dims = DeconvDims(*k)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, H, H, N)).astype(np.float32))
    x_pad, (ty, tx) = pad_input_for_tiles(x, dims)
    xw = transform_input_tiles(x_pad, (ty, tx)).reshape(B * ty * tx, 16, N).contiguous().numpy()
    pos, subs, inv, _ = tops.packed_layout(dims)
    ww = (0.02 * rng.standard_normal((len(pos), N, M))).astype(np.float32)
    return xw, ww, np.asarray(inv, np.float32), dict(pos_idx=pos, sub_slices=subs, m2=4)


def _trunc32(x):
    """float64 -> float32 rounded toward zero, as the tensor cores' adds."""
    f = np.asarray(x, np.float64).astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _starts(c, chain, nst):
    """The kernel's chain start: its first k-step zeroes the accumulator."""
    return c % chain == 0


def _ends(c, chain, nst):
    """The kernel's chain end: the accumulator folds into the outputs."""
    return (c + 1) % chain == 0 or c + 1 == nst


def _tc_model(xw, ww, inv, pos_idx, sub_slices, chain, terms=3, starts=_starts, ends=_ends):
    """domain_fwd_mma_kernel's blocks in numpy: the grid order, each packed
    position's N loop in stages of BK (zero-filled past N and T), 3xTF32
    products (``terms`` 1 keeps hi*hi only), chains of ``chain`` stages
    summed in fp32 rounded toward zero at each stage (``starts`` a chain's
    first stage, ``ends`` its last), then folded into the 4 outputs with
    rounded fp32 adds."""
    T, _, N = xw.shape
    M = ww.shape[2]
    BT, BM, BK = TC["BT"], TC["BM"], TC["BK"]
    offs, S2 = _offs(sub_slices), len(sub_slices)
    n_tb, n_mb, nst = -(-T // BT), -(-M // BM), -(-N // BK)
    xp = np.zeros((n_tb * BT, 16, nst * BK), np.float32)
    xp[:T, :, :N] = xw
    wp = np.zeros((len(pos_idx), nst * BK, n_mb * BM), np.float32)
    wp[:, :N, :M] = ww
    out = np.full((T, S2 * 4, M), np.nan, np.float32)
    for b in range(n_tb * n_mb * S2):
        rank, rem = divmod(b, n_tb * n_mb)
        s = _sub_of_rank(offs, rank)
        t0, m0 = (rem % n_tb) * BT, (rem // n_tb) * BM
        y = np.zeros((4, BT, BM), np.float32)
        for p in range(offs[s], offs[s + 1]):
            acc = np.zeros((BT, BM), np.float32)
            for c in range(nst):
                a = xp[t0:t0 + BT, pos_idx[p], c * BK:(c + 1) * BK]
                w = wp[p, c * BK:(c + 1) * BK, m0:m0 + BM]
                ah, al, _ = _split_tf32(a)
                wh, wl, _ = _split_tf32(w)
                prod = ah.astype(np.float64) @ wh
                if terms == 3:
                    prod += al.astype(np.float64) @ wh + ah.astype(np.float64) @ wl
                acc = _trunc32(prod if starts(c, chain, nst) else acc + prod)
                if ends(c, chain, nst):
                    for a_ in range(4):
                        if inv[p, a_] != 0:
                            y[a_] = (y[a_] + np.float32(inv[p, a_]) * acc).astype(np.float32)
        rows, cols = slice(t0, min(t0 + BT, T)), slice(m0, min(m0 + BM, M))
        for a_ in range(4):
            out[rows, s * 4 + a_, cols] = y[a_, : rows.stop - t0, : cols.stop - m0]
    assert not np.isnan(out).any()  # every output written, empty sub-filters as zeros
    return out


TC_CASES = {  # geom: (T, N, M): ragged T against the 128-tile block, N against 32, M against 64
    "k5s2": (150, 40, 20), "k4s2": (131, 36, 68), "k3s1": (129, 64, 16), "k2s3": (140, 32, 36)}


@pytest.mark.parametrize("geom", [*TC_CASES, "ragged"])
def test_tensor_core_block_model_matches_plain_and_jax(geom):
    xw, ww, inv, kw = _ragged_case() if geom == "ragged" else _xw_case(geom, *TC_CASES[geom], seed=11)
    want = E.domain_engine_plain(torch.from_numpy(xw), torch.from_numpy(ww), torch.from_numpy(inv), **kw).numpy()
    _close(want, jref.engine_ref(jnp.asarray(xw), jnp.asarray(ww), jnp.asarray(inv), **kw))
    nst = -(-xw.shape[2] // TC["BK"])
    for chain in sorted({1, CHAIN, nst}):
        _close(_tc_model(xw, ww, inv, kw["pos_idx"], kw["sub_slices"], chain), want)
    if geom == "k2s3":  # the empty sub-filters are zeros
        offs = _offs(kw["sub_slices"])
        empty = [s for s in range(len(offs) - 1) if offs[s] == offs[s + 1]]
        assert empty and not want[:, [4 * s + a for s in empty for a in range(4)]].any()


def test_chain_conditions_are_the_sources():
    # the model's chain start and end are the kernel's: the first k-step of
    # a chain starts the accumulator from zero, its last stage (or the
    # position's) folds it into the outputs
    assert re.search(r"const int fresh = c % kFwdChain == 0;", SRC)
    assert "wgmma_tf32(acc, al[ks], dh + 2 * ks, !(fresh && ks == 0));" in SRC
    assert "if ((c + 1) % kFwdChain == 0 || c + 1 == nst) {" in SRC
    assert TC["kFwdChain"] == CHAIN


FOLD_MUTATIONS = {  # a wrong chain boundary: each loses or repeats chains of products
    "fold_only_at_the_last_stage": (_starts, lambda c, chain, nst: c + 1 == nst),
    "fresh_at_every_stage": (lambda c, chain, nst: True, _ends),
    "never_fresh": (lambda c, chain, nst: c == 0, _ends),
    "fold_every_stage": (_starts, lambda c, chain, nst: True),
}


@pytest.mark.parametrize("mutation", FOLD_MUTATIONS)
def test_a_wrong_chain_boundary_fails_the_tolerance(mutation):
    # N = 256: 8 stages a position, two chains of 4
    xw, ww, inv, kw = _xw_case("k5s2", 130, 256, 16, seed=5)
    want = E.domain_engine_plain(torch.from_numpy(xw), torch.from_numpy(ww), torch.from_numpy(inv), **kw).numpy()
    starts, ends = FOLD_MUTATIONS[mutation]
    bad = _tc_model(xw, ww, inv, kw["pos_idx"], kw["sub_slices"], CHAIN, starts=starts, ends=ends)
    assert np.abs(bad - want).max() > 1e-4 * np.abs(want).max() + 1e-5


def test_longer_chains_lose_more_to_truncation():
    # the reason for a bounded chain: the truncating sum of a whole
    # position's 32 stages strays further from the exact products than
    # chains of kFwdChain or of 1 folded with rounded adds
    xw, ww, inv, kw = _xw_case("k5s2", 130, 1024, 16, seed=7)
    offs, T, M = _offs(kw["sub_slices"]), xw.shape[0], ww.shape[2]
    exact = np.zeros((T, 4 * (len(offs) - 1), M))
    for s in range(len(offs) - 1):
        for p in range(offs[s], offs[s + 1]):
            prod = xw[:, kw["pos_idx"][p]].astype(np.float64) @ ww[p]
            for a in range(4):
                exact[:, 4 * s + a] += float(inv[p, a]) * prod
    nst = 1024 // TC["BK"]
    err = {chain: np.abs(_tc_model(xw, ww, inv, kw["pos_idx"], kw["sub_slices"], chain) - exact).mean()
           for chain in (1, CHAIN, nst)}
    assert err[1] < err[nst] and err[CHAIN] < err[nst], err


def test_one_tf32_product_fails_the_tolerance():
    # the model's own check: hi*hi alone (1xTF32) is not fp32-accurate, the three terms are
    xw, ww, inv, kw = _xw_case("k5s2", 130, 256, 16, seed=5)
    want = E.domain_engine_plain(torch.from_numpy(xw), torch.from_numpy(ww), torch.from_numpy(inv), **kw).numpy()
    one = _tc_model(xw, ww, inv, kw["pos_idx"], kw["sub_slices"], CHAIN, terms=1)
    assert np.abs(one - want).max() > 1e-4 * np.abs(want).max() + 1e-5
    _close(_tc_model(xw, ww, inv, kw["pos_idx"], kw["sub_slices"], CHAIN), want)


# ------------------------------------------------------------ few channels
def _few_items(S2):
    """domain_fwd_few_kernel's (tile, sub-filter) items a thread, in turn."""
    return -(-FC["BT"] * S2 // FC["kThreads"])


def _few_model(xw, ww, inv, pos_idx, sub_slices):
    """domain_fwd_few_kernel's blocks in numpy: (T block, 4-channel chunk),
    thread items (tile, sub-filter) in turn, chunks of BN channels n added
    into each position's dot product, the products folded through inv once
    after the N loop."""
    T, _, N = xw.shape
    M = ww.shape[2]
    BT, MC, BN, NT = FC["BT"], FC["MC"], FC["BN"], FC["kThreads"]
    offs, S2 = _offs(sub_slices), len(sub_slices)
    out = np.full((T, S2 * 4, M), np.nan, np.float32)
    for t0 in range(0, T, BT):
        for m0 in range(0, M, MC):
            xs = np.zeros((BT, 16, -(-N // BN) * BN), np.float32)  # the copies' zero fill past T and N
            xs[: min(BT, T - t0), :, :N] = xw[t0:t0 + BT]
            ws = np.zeros((len(pos_idx), xs.shape[2], MC), np.float32)
            ws[:, :N, : min(MC, M - m0)] = ww[:, :, m0:m0 + MC]
            for j in range(_few_items(S2)):
                for tid in range(NT):
                    item = tid + j * NT
                    tl, s = item % BT, item // BT
                    if s >= S2 or t0 + tl >= T:
                        continue
                    lo, hi = offs[s], offs[s + 1]
                    d = np.zeros((hi - lo, MC), np.float32)
                    for c in range(0, xs.shape[2], BN):
                        for k, p in enumerate(range(lo, hi)):
                            d[k] = (d[k] + xs[tl, pos_idx[p], c:c + BN].astype(np.float64) @ ws[p, c:c + BN]
                                    ).astype(np.float32)
                    y = np.zeros((4, MC), np.float32)
                    for k, p in enumerate(range(lo, hi)):
                        for a in range(4):
                            if inv[p, a] != 0:
                                y[a] = (y[a] + np.float32(inv[p, a]) * d[k]).astype(np.float32)
                    mc = min(MC, M - m0)
                    out[t0 + tl, 4 * s:4 * s + 4, m0:m0 + mc] = y[:, :mc]
    assert not np.isnan(out).any()
    return out


FEW_CASES = {"k5s2": (70, 24, 3), "k4s2": (65, 16, 5), "k3s1": (130, 12, 3), "k2s3": (40, 8, 6)}


@pytest.mark.parametrize("geom", list(FEW_CASES))
def test_few_channel_block_model_matches_plain_and_jax(geom):
    xw, ww, inv, kw = _xw_case(geom, *FEW_CASES[geom], seed=21)
    want = E.domain_engine_plain(torch.from_numpy(xw), torch.from_numpy(ww), torch.from_numpy(inv), **kw).numpy()
    _close(want, jref.engine_ref(jnp.asarray(xw), jnp.asarray(ww), jnp.asarray(inv), **kw))
    _close(_few_model(xw, ww, inv, kw["pos_idx"], kw["sub_slices"]), want)


@pytest.mark.parametrize("S2", [1, 4, 9, 16])
def test_few_channel_items_are_warp_uniform_and_conflict_free(S2):
    BT, BN, TS, NT = FC["BT"], FC["BN"], FC["TS"], FC["kThreads"]
    covered = set()
    for warp in range(NT // 32):
        for j in range(_few_items(S2)):
            items = [warp * 32 + lane + j * NT for lane in range(32)]
            subs = {it // BT for it in items}
            assert len(subs) == 1  # one sub-filter a warp: its positions and weights are uniform
            covered |= {it for it in items if it // BT < S2}
            # a float4 of one (position, n) per lane, at the kernel's qoff: each 8-lane phase on 8 distinct
            # 16-byte bank groups
            for q in (0, 7, 15):
                for n in range(0, BN, 4):
                    words = [(it % BT) * TS + q * BN + n for it in items]
                    for ph in range(4):
                        assert len({(w // 4) % 8 for w in words[8 * ph:8 * ph + 8]}) == 8
    assert covered == set(range(BT * S2))
