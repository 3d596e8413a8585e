"""Port parity of the Winograd conv engine (the engine's strided-conv corner).

* Geometry and layout: ``conv_plan`` counts (36 for K4S2, 16 for K3S1, and
  K3S2), ``pack_conv_weights`` / ``prepack_conv``, ``conv_cells_from_image``
  and ``conv_cells_to_next`` (odd extents included) against the JAX package.
* The plain forward (``conv_fused_engine`` on CPU tensors) against JAX
  ``conv_engine_ref`` over the four activations, scale and bias on and off,
  both out modes and K4S2, K3S2 and K3S1.
* The plain backward versions against ``jax.vjp`` of ``conv_engine_ref``,
  and the autograd Function against ``jax.vjp`` of JAX
  ``winograd_conv2d_cells(backend="ref")``; at one tiny K4S2 shape, against
  the Pallas kernels themselves in interpret mode.

Tolerances: forward atol 5e-5, rtol 1e-4 (fp32 sums in another order);
gradients ``1e-4 * max|ref| + 1e-5`` per array, as the deconv corner's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tdc as jtdc
from repro.core.winograd import get_transform as jget_transform
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import ConvDims, conv_plan, conv_same_dims
from repro_torch.kernels import engine as E
from repro_torch.kernels import ops as tops

# name -> (K, S, H, W): even and odd extents
GEOMS = {"k4s2": (4, 2, 8, 8), "k4s2_odd": (4, 2, 7, 9), "k3s2": (3, 2, 8, 6), "k3s1": (3, 1, 6, 5)}
ACTS = ("none", "relu", "leaky_relu", "tanh")


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-5)


def _dims(geom):
    K, S, H, W = GEOMS[geom]
    jd = jtdc.conv_same_dims(K, S, H)
    return jd, ConvDims(jd.kernel, jd.stride, jd.padding, jd.pad_hi), H, W


def _bt():
    return tuple(tuple(float(v) for v in row) for row in jget_transform(2, 3).BT)


def _geo(td, H, W):
    """(geometry kwargs of the engine wrappers, gy, gx) for an (H, W) input."""
    pos, _, _ = tops.conv_packed_layout(td)
    ty, tx = -(-td.out_size(H) // 2), -(-td.out_size(W) // 2)
    return dict(pos_idx=pos, m=2, n=4, ty=ty, tx=tx, s2=td.stride ** 2), ty + 1, tx + 1


@pytest.mark.parametrize("K,S,H,c_total", [(4, 2, 64, 36), (4, 2, 7, 36), (3, 1, 8, 16), (3, 2, 8, 36), (3, 2, 9, 25)])
def test_conv_plan_counts_match_jax(K, S, H, c_total):
    td, jd = conv_same_dims(K, S, H), jtdc.conv_same_dims(K, S, H)
    assert (td.kernel, td.stride, td.padding, td.pad_hi) == (jd.kernel, jd.stride, jd.padding, jd.pad_hi)
    assert (td.phase_pad, td.out_size(H)) == (jd.phase_pad, jd.out_size(H))
    assert [td.phase_of(r) for r in range(S)] == [jd.phase_of(r) for r in range(S)]
    assert [td.shift_of(r) for r in range(S)] == [jd.shift_of(r) for r in range(S)]
    tp, jp = conv_plan(td), jtdc.conv_plan(jd)
    assert tp.c_total == jp.c_total == c_total
    assert tp.taps_1d == jp.taps_1d
    np.testing.assert_array_equal(tp.masks_winograd, jp.masks_winograd)
    np.testing.assert_array_equal(tp.nnz_winograd, jp.nnz_winograd)


def test_conv_tap_window_that_does_not_fit_raises():
    with pytest.raises(ValueError, match="exceeds r"):
        conv_plan(ConvDims(5, 1, 0, 0))


@pytest.mark.parametrize("geom", list(GEOMS))
def test_pack_conv_weights_and_prepack_match_jax(geom):
    jd, td, _, _ = _dims(geom)
    w = np.random.default_rng(1).standard_normal((jd.kernel, jd.kernel, 3, 5)).astype(np.float32)
    jp = jops.prepack_conv(jnp.asarray(w), jd)
    tp = tops.prepack_conv(torch.from_numpy(w), td)
    assert tops.conv_packed_layout(td)[0] == jops.conv_packed_layout(jd)[0]
    np.testing.assert_array_equal(tp.inv.numpy(), np.asarray(jp.inv))
    np.testing.assert_allclose(tp.ww.numpy(), np.asarray(jp.ww), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tops.pack_conv_weights(torch.from_numpy(w), td).numpy(), np.asarray(jp.ww),
                               rtol=1e-6, atol=1e-6)
    assert tp.inv is tops.conv_packed_inv(td, "cpu")  # cached, one copy per device


@pytest.mark.parametrize("geom", list(GEOMS))
def test_conv_cells_from_image_matches_jax(geom):
    jd, td, H, W = _dims(geom)
    x = np.random.default_rng(2).standard_normal((2, H, W, 3)).astype(np.float32)
    got = tops.conv_cells_from_image(torch.from_numpy(x), td).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.conv_cells_from_image(jnp.asarray(x), jd)))


@pytest.mark.parametrize("H,W", [(16, 16), (13, 11)], ids=["even", "odd"])
def test_conv_cells_to_next_matches_jax(H, W):
    """A K4S2 layer's emitted cells -> the next K4S2 layer's cells, and the
    chain agrees with building the next cells from the image."""
    jd, jd2 = jtdc.conv_same_dims(4, 2, H), jtdc.conv_same_dims(4, 2, -(-H // 2))
    td, td2 = (ConvDims(d.kernel, d.stride, d.padding, d.pad_hi) for d in (jd, jd2))
    assert tops.conv_chain_aligned(td, td2) and jops.conv_chain_aligned(jd, jd2)
    HO, WO = td.out_size(H), td.out_size(W)
    emitted = np.random.default_rng(3).standard_normal((2, -(-HO // 2), -(-WO // 2), 4, 5)).astype(np.float32)
    emitted = np.asarray(jops.cells_window_mask(emitted.shape[1], emitted.shape[2], 2, 0, HO, WO)) * emitted
    got = tops.conv_cells_to_next(torch.from_numpy(emitted), td, td2, (HO, WO)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.conv_cells_to_next(jnp.asarray(emitted), jd, jd2, (HO, WO))))
    # the hop is the same as re-laying out the image
    img = torch.from_numpy(emitted).reshape(2, emitted.shape[1], emitted.shape[2], 2, 2, 5)
    img = img.permute(0, 1, 3, 2, 4, 5).reshape(2, 2 * emitted.shape[1], 2 * emitted.shape[2], 5)[:, :HO, :WO]
    np.testing.assert_array_equal(got, tops.conv_cells_from_image(img.contiguous(), td2).numpy())
    # the port chains only hops whose next stride is the cell stride m = 2
    for nxt in (ConvDims(3, 1, 2, 0), ConvDims(3, 1, 1, 1), ConvDims(3, 3, 1, 1)):
        assert not tops.conv_chain_aligned(td, nxt)
        with pytest.raises(ValueError, match="misaligned"):
            tops.conv_cells_to_next(torch.from_numpy(emitted), td, nxt, (HO, WO))


@pytest.mark.parametrize("mode", ["nhwc", "cells"])
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("geom", ["k4s2", "k4s2_odd", "k3s2", "k3s1"])
def test_plain_forward_matches_conv_engine_ref(geom, act, affine, mode):
    jd, td, H, W = _dims(geom)
    B, N, M = 2, 3, 5
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, H, W, N)).astype(np.float32)
    w = (0.5 * rng.standard_normal((jd.kernel, jd.kernel, N, M))).astype(np.float32)
    scale = (0.3 * rng.standard_normal(M) + 1.0).astype(np.float32) if affine else None
    bias = (0.2 * rng.standard_normal(M)).astype(np.float32) if affine else None
    jp = jops.prepack_conv(jnp.asarray(w), jd)
    cells = np.asarray(jops.conv_cells_from_image(jnp.asarray(x), jd))
    geo, _, _ = _geo(td, H, W)
    HO, WO = td.out_size(H), td.out_size(W)
    want = jref.conv_engine_ref(
        jnp.asarray(cells), jp.ww, jp.inv, _bt(), None if scale is None else jnp.asarray(scale),
        None if bias is None else jnp.asarray(bias), out_mode=mode, activation=act, out_h=HO, out_w=WO, **geo)
    want = np.asarray(want)[:, :HO, :WO] if mode == "nhwc" else np.asarray(want)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    before = E.conv_fused_engine.launches
    got = E.conv_fused_engine(t(cells), t(jp.ww), t(jp.inv), out_mode=mode, activation=act, scale=t(scale),
                              bias=t(bias), out_h=HO, out_w=WO, **geo)
    assert E.conv_fused_engine.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("extra", [(0, 0), (2, 1)], ids=["exact", "more_cells"])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_plain_backward_matches_jax_vjp(geom, extra):
    """bwd_x and bwd_w plain versions against jax.vjp of ``conv_engine_ref``
    (no epilogue, the products' cotangent relaid as the output image), on
    cells that cover the tiles exactly and on cells with rows and columns
    past them."""
    jd, td, H, W = _dims(geom)
    geo, gy, gx = _geo(td, H, W)
    gy, gx = gy + extra[0], gx + extra[1]
    ty, tx, s2 = geo["ty"], geo["tx"], geo["s2"]
    B, N, M = 2, 3, 5
    rng = np.random.default_rng(5)
    g = rng.standard_normal((B, ty, tx, 4, M)).astype(np.float32)
    ww = rng.standard_normal((len(geo["pos_idx"]), N, M)).astype(np.float32)
    cells = rng.standard_normal((B, gy, gx, s2 * 4, N)).astype(np.float32)
    inv = jops.conv_packed_layout(jd)[1]

    def jf(c, w):
        return jref.conv_engine_ref(c, w, jnp.asarray(inv), _bt(), None, None, out_mode="nhwc", activation="none",
                                    out_h=2 * ty, out_w=2 * tx, **geo)

    _, vjp = jax.vjp(jf, jnp.asarray(cells), jnp.asarray(ww))
    g_img = g.reshape(B, ty, tx, 2, 2, M).transpose(0, 1, 3, 2, 4, 5).reshape(B, 2 * ty, 2 * tx, M)
    want_x, want_w = vjp(jnp.asarray(g_img))
    t = torch.from_numpy
    before = (E.conv_fused_engine_bwd_x.launches, E.conv_fused_engine_bwd_w.launches)
    got_x = E.conv_fused_engine_bwd_x(t(g), t(ww), t(inv), gy=gy, gx=gx, **geo)
    got_w = E.conv_fused_engine_bwd_w(t(cells), t(g), t(inv), **geo)
    assert (E.conv_fused_engine_bwd_x.launches, E.conv_fused_engine_bwd_w.launches) == before
    _close(got_x.numpy(), want_x)
    _close(got_w.numpy(), want_w)
    # rows and columns the forward never reads get exactly zero
    assert not got_x[:, ty + 1:].any() and not got_x[:, :, tx + 1:].any()


def _fn_case(geom, act, affine, mode, seed, M):
    jd, td, H, W = _dims(geom)
    B, N = 2, 4
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, N)).astype(np.float32)
    w = (0.5 * rng.standard_normal((jd.kernel, jd.kernel, N, M))).astype(np.float32)
    scale = (0.3 * rng.standard_normal(M) + 1.2).astype(np.float32) if affine else None
    bias = (0.2 * rng.standard_normal(M)).astype(np.float32) if affine else None
    return jd, td, H, W, x, w, scale, bias, rng


def _fn_vs_jax(geom, act, affine, mode, jax_kw, seed=6, M=5):
    """The port's ConvEpilogueFn on CPU tensors against jax.vjp of JAX
    ``winograd_conv2d_cells`` (with ``jax_kw``): output, dcells, dww,
    dscale, dbias."""
    jd, td, H, W, x, w, scale, bias, rng = _fn_case(geom, act, affine, mode, seed, M)
    jp = jops.prepack_conv(jnp.asarray(w), jd)
    jcells = jops.conv_cells_from_image(jnp.asarray(x), jd)
    emit = mode == "cells"

    def jf(c, ww, sc, bi):
        return jops.winograd_conv2d_cells(c, jops.PackedConv(ww, jp.inv), jd, (H, W), epilogue=act, scale=sc,
                                          bias=bi, emit_cells=emit, **jax_kw)

    args = (jcells, jp.ww, None if scale is None else jnp.asarray(scale), None if bias is None else jnp.asarray(bias))
    y, vjp = jax.vjp(jf, *args)
    cot = rng.standard_normal(y.shape).astype(np.float32)
    want = vjp(jnp.asarray(cot))

    t = lambda a: None if a is None else torch.from_numpy(np.array(a)).requires_grad_()  # noqa: E731
    tc, tww, tsc, tbi = t(jcells), t(jp.ww), t(scale), t(bias)
    got_y = tops.winograd_conv2d_cells(tc, tops.PackedConv(tww, tops.conv_packed_inv(td, "cpu")), td, (H, W),
                                       backend="cuda", epilogue=act, scale=tsc, bias=tbi, emit_cells=emit)
    assert got_y.grad_fn is not None and "ConvEpilogueFn" in type(got_y.grad_fn).__name__
    _close(got_y.detach().numpy(), y)
    leaves = [a for a in (tc, tww, tsc, tbi) if a is not None]
    grads = torch.autograd.grad(got_y, leaves, torch.from_numpy(cot))
    for got, w_ in zip(grads, [w_ for w_, a in zip(want, args) if a is not None]):
        _close(got.numpy(), w_)


@pytest.mark.parametrize("mode", ["nhwc", "cells"])
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("act", ACTS)
def test_autograd_fn_matches_jax_vjp(act, affine, mode):
    """The geometry rotates with the case."""
    geom = list(GEOMS)[(ACTS.index(act) + 2 * affine + (mode == "cells")) % len(GEOMS)]
    _fn_vs_jax(geom, act, affine, mode, dict(backend="ref"))


@pytest.mark.parametrize("mode", ["nhwc", "cells"])
def test_autograd_fn_matches_pallas_interpret(mode):
    """The Pallas conv engine and its two backward kernels themselves
    (interpret mode), at one tiny K4S2 shape whose M fills the Pallas
    engine's 8-channel block (its emitted cells carry block-padded channels)."""
    _fn_vs_jax("k4s2", "leaky_relu", True, mode, dict(backend="pallas", interpret=True, **jops.INTERPRET_BLOCKS_CONV),
               M=8)


def test_function_skips_the_gradients_nobody_asks_for(monkeypatch):
    """conv0 on real images: cells need no gradient, so bwd_x never runs;
    with frozen weights, bwd_w never runs."""
    jd, td, H, W = _dims("k4s2")
    x = torch.randn(1, H, W, 3)
    packed = tops.prepack_conv(0.1 * torch.randn(4, 4, 3, 5), td)
    calls = []
    real_x, real_w = E.conv_fused_engine_bwd_x, E.conv_fused_engine_bwd_w
    monkeypatch.setattr(E, "conv_fused_engine_bwd_x", lambda *a, **k: (calls.append("x"), real_x(*a, **k))[1])
    monkeypatch.setattr(E, "conv_fused_engine_bwd_w", lambda *a, **k: (calls.append("w"), real_w(*a, **k))[1])
    ww = packed.ww.clone().requires_grad_()
    y = tops.winograd_conv2d_packed(x, tops.PackedConv(ww, packed.inv), td, epilogue="leaky_relu")
    torch.autograd.grad(y.sum(), [ww])
    assert calls == ["w"]
    xg = x.clone().requires_grad_()
    y = tops.winograd_conv2d_packed(xg, packed, td, epilogue="leaky_relu", emit_cells=True)
    torch.autograd.grad(y.sum(), [xg])
    assert calls == ["w", "x"]


def test_backends_agree_and_unknown_backend_raises():
    jd, td, H, W = _dims("k4s2_odd")
    x = torch.randn(2, H, W, 3, generator=torch.Generator().manual_seed(0))
    packed = tops.prepack_conv(torch.randn(4, 4, 3, 5, generator=torch.Generator().manual_seed(1)), td)
    a = tops.winograd_conv2d_packed(x, packed, td, epilogue="tanh", backend="cuda")
    b = tops.winograd_conv2d_packed(x, packed, td, epilogue="tanh", backend="ref")
    assert tuple(a.shape) == (2, td.out_size(H), td.out_size(W), 5) and torch.equal(a, b)
    with pytest.raises(ValueError, match="backend"):
        tops.winograd_conv2d_packed(x, packed, td, backend="pallas")


def test_conv_wrappers_refuse_other_devices_and_bad_layouts():
    jd, td, H, W = _dims("k4s2")
    geo, gy, gx = _geo(td, H, W)
    C = len(geo["pos_idx"])
    meta = lambda *shape: torch.zeros(shape, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="cpu or cuda"):
        E.conv_fused_engine(meta(1, gy, gx, 16, 4), meta(C, 4, 3), meta(C, 4), out_mode="nhwc", out_h=4, out_w=4, **geo)
    with pytest.raises(ValueError, match="cpu or cuda"):
        E.conv_fused_engine_bwd_x(meta(1, geo["ty"], geo["tx"], 4, 3), meta(C, 4, 3), meta(C, 4), gy=gy, gx=gx, **geo)
    with pytest.raises(ValueError, match="cpu or cuda"):
        E.conv_fused_engine_bwd_w(meta(1, gy, gx, 16, 4), meta(1, geo["ty"], geo["tx"], 4, 3), meta(C, 4), **geo)
    with pytest.raises(ValueError, match="out_mode"):
        E.conv_fused_engine(torch.zeros(1, gy, gx, 16, 4), torch.zeros(C, 4, 3), torch.zeros(C, 4), out_mode="img",
                            out_h=4, out_w=4, **geo)
    # the kernels take positions grouped by phase, distinct within a phase
    E._conv_layout_tensors(geo["pos_idx"], 4, "cpu")
    for bad in (tuple(reversed(geo["pos_idx"])), geo["pos_idx"][:2] + geo["pos_idx"][:2], (70,)):
        with pytest.raises(ValueError, match="grouped by phase"):
            E._conv_layout_tensors(bad, 4, "cpu")
