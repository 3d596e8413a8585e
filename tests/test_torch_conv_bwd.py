"""Kernels 6 and 7 at the conv corner (``conv_engine.cu``'s bwd_x and bwd_w),
at the edges of their tensor-core routes.

* The plain versions that ``chip_smoke.py`` holds the CUDA kernels to
  (``conv_fused_engine_bwd_x_plain`` / ``_bwd_w_plain``) against ``jax.vjp``
  of the JAX package's ``conv_engine_ref``, at the smoke's ragged K4S2 shape
  (batch 7, 11 x 11 input, 100 -> 36 channels: N and M multiples of 4 but
  not of the block tiles, T = 63 tiles, not a multiple of the 8-tile chunk)
  and at DCGAN's conv0 widths (N = 3 in a 16-channel n tile, M = 64);
  tolerance ``1e-4 * max|ref| + 1e-5`` per array, as the smoke's.
* The 16-byte alignment table at the conv corner's shapes.
* The smoke's kernel-name matching, which tells the two corners' kernels
  apart (and counts the non-template CUDA-core kernels).
* The cell and g layouts of the two corners, as the tensor-core bwd_w's one
  block body (``bwd_w_core.cuh::window_block``) addresses them.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tdc as jtdc
from repro.core.winograd import get_transform as jget_transform
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import ConvDims, DeconvDims
from repro_torch.kernels import engine as E
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parents[1]


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _module(ROOT / "chip_smoke.py")

# name -> (K, S, B, H, N, M)
SHAPES = {"ragged": smoke.CONV_RAGGED_SHAPE[1:5] + smoke.CONV_RAGGED_SHAPE[6:8], "conv0": (4, 2, 2, 16, 3, 64)}


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-5)


def test_the_ragged_shape_sits_off_every_block_tile():
    name, K, S, B, H, W, N, M = smoke.CONV_RAGGED_SHAPE[:8]
    jd = jtdc.conv_same_dims(K, S, H)
    ty = -(-jd.out_size(H) // 2)
    assert (H, W, B * ty * ty) == (11, 11, 63) and (B * ty * ty) % 8
    assert N % 4 == 0 == M % 4 and N % 64 and M % 128


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_backward_matches_jax_vjp_at_the_kernels_edges(shape):
    K, S, B, H, N, M = SHAPES[shape]
    jd = jtdc.conv_same_dims(K, S, H)
    td = ConvDims(jd.kernel, jd.stride, jd.padding, jd.pad_hi)
    pos = tops.conv_packed_layout(td)[0]
    ty = tx = -(-td.out_size(H) // 2)
    geo = dict(pos_idx=pos, m=2, n=4, ty=ty, tx=tx, s2=S * S)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((B, H, H, N)).astype(np.float32)
    cells = tops.conv_cells_from_image(torch.from_numpy(x), td).numpy()
    gy, gx = cells.shape[1:3]
    g = rng.standard_normal((B, ty, tx, 4, M)).astype(np.float32)
    ww = (0.1 * rng.standard_normal((len(pos), N, M))).astype(np.float32)
    inv = jops.conv_packed_layout(jd)[1]
    bt = tuple(tuple(float(v) for v in row) for row in jget_transform(2, 3).BT)

    def jf(c, w):
        return jref.conv_engine_ref(c, w, jnp.asarray(inv), bt, None, None, out_mode="nhwc", activation="none",
                                    out_h=2 * ty, out_w=2 * tx, **geo)

    _, vjp = jax.vjp(jf, jnp.asarray(cells), jnp.asarray(ww))
    g_img = g.reshape(B, ty, tx, 2, 2, M).transpose(0, 1, 3, 2, 4, 5).reshape(B, 2 * ty, 2 * tx, M)
    want_x, want_w = vjp(jnp.asarray(g_img))
    t = torch.from_numpy
    got_x = E.conv_fused_engine_bwd_x_plain(t(g), t(ww), t(np.asarray(inv)), gy=gy, gx=gx, **geo)
    got_w = E.conv_fused_engine_bwd_w_plain(t(cells), t(g), t(np.asarray(inv)), **geo)
    assert got_x.shape == (B, gy, gx, S * S * 4, N) and got_w.shape == (len(pos), N, M)
    _close(got_x.numpy(), want_x)
    _close(got_w.numpy(), want_w)


@pytest.mark.parametrize("N,M", [(3, 64), (64, 128), (128, 256), (256, 512), (100, 36), (3, 3), (36, 20)])
def test_the_alignment_table_names_what_the_conv_kernels_copy_in_16_bytes(N, M):
    """The tensor-core bwd_x (M % 4 == 0, M >= 8) stages g and ww in 16-byte
    copies; bwd_w stages the cell windows so where N % 4 == 0 and g where M %
    4 == 0 and M >= 16."""
    bx, bw = E._SIXTEEN_BYTE_COPIES["conv_fused_engine_bwd_x"], E._SIXTEEN_BYTE_COPIES["conv_fused_engine_bwd_w"]
    tensor_cores_x = M % 4 == 0 and M >= 8
    assert bx["g"](N, M) == bx["ww_packed"](N, M) == tensor_cores_x
    assert bw["cells"](N, M) == (N % 4 == 0)
    assert bw["g"](N, M) == (M % 4 == 0 and M >= 16)


PROFILED = {  # kernel names as the profiler reports them on the card
    "deconv_x_cuda_cores": "(anonymous namespace)::bwd_x_kernel(float const*, float const*, int, int)",
    "deconv_x": "void (anonymous namespace)::bwd_x_mma_kernel<bwdx::Core<16, 4, 2, 2, 8, 2> >(float const*)",
    "conv_x_cuda_cores": "void (anonymous namespace)::conv_bwd_x_kernel<4, 32, 1>(float const*, int)",
    "conv_x": "void (anonymous namespace)::conv_bwd_x_mma_kernel<bwdx::Core<16, 4, 2, 2, 8, 2> >(float const*)",
    "domain_x": "void (anonymous namespace)::domain_bwd_x_mma_kernel<bwdx::Core<16, 4, 2, 2, 8, 2> >(float)",
    "deconv_w": "void (anonymous namespace)::bwd_w_kernel<true>(float const*, int)",
    "conv_w": "void (anonymous namespace)::conv_bwd_w_mma_kernel<bwdw::Core<1, 4, 4, 4, 8, 4, 4>, true>(float)",
    "conv_fwd": "void (anonymous namespace)::conv_fwd_kernel<8, 8, 8, 16, 4, 4>(float const*, int)",
    "e1_cuda_cores": "void (anonymous namespace)::engine1d_kernel<32, 1, 8, 1, 1>(float const*, int)",
    "e1": "void (anonymous namespace)::engine1d_mma_kernel<fwd::Core<2, 4, 2, 4, 9, 2, 2, 1> >(float const*)",
    "cudnn": "void cudnn::engines_precompiled::scalePackedTensor_kernel<float, float>(float*)",
    # TPU kernel 1's instantiations, as the card's profiler named them
    "domain_fwd_cuda_cores": "void (anonymous namespace)::domain_fwd_kernel<8, 8, 8, 16, 4, true>(float const*, int)",
    "domain_fwd_mma": "(anonymous namespace)::domain_fwd_mma_kernel(CUtensorMap_st, CUtensorMap_st, float const*, int)",
    "domain_fwd_pack": "(anonymous namespace)::domain_fwd_pack_kernel(float const*, float*, int, int, int)",
    "domain_fwd_few": "(anonymous namespace)::domain_fwd_few_kernel(float const*, float const*, float const*, int)",
}


@pytest.mark.parametrize("names,want", [
    ("BWD_X_KERNELS", {"deconv_x_cuda_cores", "deconv_x"}),
    ("CONV_BWD_X_KERNELS", {"conv_x_cuda_cores", "conv_x"}),
    ("DOMAIN_BWD_X_KERNELS", {"domain_x"}),
    ("BWD_W_KERNELS", {"deconv_w"}),
    ("CONV_BWD_W_KERNELS", {"conv_w"}),
    ("ENGINE1D_KERNELS", {"e1_cuda_cores", "e1"}),
    ("STEP_KERNELS", set(PROFILED) - {"cudnn", "e1_cuda_cores", "e1"}),
    ("DOMAIN_FWD_KERNELS", {"domain_fwd_cuda_cores", "domain_fwd_mma", "domain_fwd_pack", "domain_fwd_few"}),
    ("DOMAIN_FWD_MMA", {"domain_fwd_mma", "domain_fwd_pack"}),
])
def test_kernel_names_tell_the_two_corners_apart(names, want):
    """Each tuple catches its own kernels, template instantiations or not
    (the deconv corner's CUDA-core bwd_x is not a template: a match on
    ``::name<`` alone missed it), and never the other corner's, whose names
    contain it (``conv_bwd_x_kernel`` holds ``bwd_x_kernel``)."""
    got = {k for k, v in PROFILED.items() if smoke.kernel_named(v, getattr(smoke, names))}
    assert got == want


def _window_block_model(cells, g, inv, blocks, ty, tx, conv):
    """dww as ``bwdw::window_block`` forms it, in float64: for each packed
    position p at Winograd position q = (u, v) of phase or sub-filter s, the
    four window entries that rows u and v of B^T read, at their offsets in
    rows of N from the tile's first window cell, and g's four rows of s."""
    B, Gy, Gx, rows, N = cells.shape
    S2 = rows // 4 if conv else g.shape[3] // 4
    cs, s2m2 = (4 * S2, 4) if conv else (4, 4 * S2)
    flat, T = cells.reshape(-1, N).astype(np.float64), B * ty * tx
    b, jy, jx = np.unravel_index(np.arange(T), (B, ty, tx))
    base = ((b * Gy + jy) * Gx + jx) * cs
    gt = g.reshape(T, s2m2, -1).astype(np.float64)
    bt = np.asarray(jget_transform(2, 3).BT, np.float64)
    out = []
    for p, (q, s) in enumerate(blocks):
        sub, srow = (4 * s, 0) if conv else (0, 4 * s)
        u, v = divmod(q, 4)
        x = sum(bt[u, a] * bt[v, c] * flat[base + ((a >> 1) * Gx + (c >> 1)) * cs + sub + 2 * (a & 1) + (c & 1)]
                for a in range(4) if bt[u, a] for c in range(4) if bt[v, c])
        gw = sum(float(inv[p, a]) * gt[:, srow + a] for a in range(4))
        out.append(x.T @ gw)
    return np.stack(out)


@pytest.mark.parametrize("corner", ["deconv", "conv"])
def test_the_shared_bwd_w_block_addresses_each_corners_layout(corner):
    """Kernel 7's one tensor-core block body serves both corners, the corner a
    compile-time choice of layout: the deconv corner's cells hold one phase
    (4 rows a cell) and g the S^2 sub-filters' rows of a tile; the conv
    corner's cells hold the S^2 phases (phase s at rows 4s .. 4s+3) and g one
    sub-filter's 4 rows.  Modelled in numpy at each corner's ragged shape
    (T = 252 / 63 tiles, N = 100, M = 36), it gives the plain bwd_w."""
    rng = np.random.default_rng(23)
    B, H, N, M = 7, 11, 100, 36
    x = torch.from_numpy(rng.standard_normal((B, H, H, N)).astype(np.float32))
    if corner == "deconv":
        dims = DeconvDims(5, 2, 2, 1)  # chip_smoke.RAGGED_SHAPE
        pos, subs, inv, _ = tops.packed_layout(dims)
        blocks = [(q, next(s for s, (lo, hi) in enumerate(subs) if lo <= p < hi)) for p, q in enumerate(pos)]
        ty = tx = -(-dims.j_extent(H) // 2)
        cells = tops.cells_from_image(x, dims)
        g = torch.from_numpy(rng.standard_normal((B, ty, tx, 16, M)).astype(np.float32))
        want = E.fused_engine_bwd_w_plain(cells, g, torch.from_numpy(np.asarray(inv, np.float32)), stride=2,
                                          pos_idx=tuple(pos), sub_slices=tuple(subs), m=2, n=4, ty=ty, tx=tx)
    else:
        K, S = smoke.CONV_RAGGED_SHAPE[1:3]
        jd = jtdc.conv_same_dims(K, S, H)
        td = ConvDims(jd.kernel, jd.stride, jd.padding, jd.pad_hi)
        pos, inv, _ = tops.conv_packed_layout(td)
        blocks = [divmod(q, 16)[::-1] for q in pos]
        ty = tx = -(-td.out_size(H) // 2)
        cells = tops.conv_cells_from_image(x, td)
        g = torch.from_numpy(rng.standard_normal((B, ty, tx, 4, M)).astype(np.float32))
        want = E.conv_fused_engine_bwd_w_plain(cells, g, torch.from_numpy(np.asarray(inv, np.float32)),
                                               pos_idx=tuple(pos), m=2, n=4, ty=ty, tx=tx, s2=S * S)
    got = _window_block_model(cells.numpy(), g.numpy(), np.asarray(inv), blocks, ty, tx, corner == "conv")
    assert len(blocks) == want.shape[0] and B * ty * tx == (252 if corner == "deconv" else 63)
    _close(got, want.numpy())
