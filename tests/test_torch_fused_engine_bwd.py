"""Port parity of the fused engine's backward.

* The plain versions of the two backward kernels (``fused_engine_bwd_x_plain``,
  ``fused_engine_bwd_w_plain``) against the JAX oracles
  ``fused_pre_engine_bwd_x_ref`` / ``_bwd_w_ref`` over K5S2, K4S2, K3S1 and
  K2S3, on cells with more rows and columns than the engine reads, and
  against the Pallas backward kernels themselves in interpret mode.
* The autograd Function (``backend="cuda"`` on CPU tensors, which takes the
  plain versions) against ``jax.vjp`` of JAX ``winograd_deconv2d_cells``
  with ``backend="ref"``: dcells, dww, dscale and dbias over the four
  activations, scale/bias on and off, both out modes.
* A tripwire: training the ``cuda_chained`` generator calls each backward
  wrapper once per layer.

Tolerance: atol ``1e-4 * max|ref| + 1e-5`` per array (fp32 sums in another
order; the tanh scale cotangent comes from the saved activation through
atanh, as the reference's own custom VJP does).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tdc as jtdc
from repro.core.winograd import get_transform as jget_transform
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import winograd_deconv as jwd
from repro_torch.configs import gan_zoo as tzoo
from repro_torch.core import DeconvDims
from repro_torch.kernels import engine as E
from repro_torch.kernels import ops as tops
from repro_torch.models import gan as TG

GEOMS = {"k5s2": (5, 2, 2, 1), "k4s2": (4, 2, 1, 0), "k3s1": (3, 1, 1, 0), "k2s3": (2, 3, 0, 0)}
ACTS = ("none", "relu", "leaky_relu", "tanh")


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-5)


def _geometry(geom, H=4, W=5):
    td = DeconvDims(*GEOMS[geom])
    pos, subs, inv, _ = tops.packed_layout(td)
    ty, tx = -(-td.j_extent(H) // 2), -(-td.j_extent(W) // 2)
    return td, pos, subs, inv, ty, tx


def _bt():
    return tuple(tuple(float(v) for v in row) for row in jget_transform(2, 3).BT)


@pytest.mark.parametrize("extra", [(0, 0), (3, 2)], ids=["exact", "more_cells"])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_bwd_plain_matches_jax_oracles(geom, extra):
    """bwd_x and bwd_w plain versions against the JAX oracles, on cells that
    cover the tiles exactly and on cells with rows and columns past them
    (as a pass-through from ``cells_to_next`` gives)."""
    td, pos, subs, inv, ty, tx = _geometry(geom)
    S = td.stride
    B, N, M = 2, 6, 5
    gy, gx = ty + 1 + extra[0], tx + 1 + extra[1]
    rng = np.random.default_rng(7)
    g = rng.standard_normal((B, ty, tx, S * S * 4, M)).astype(np.float32)
    ww = rng.standard_normal((len(pos), N, M)).astype(np.float32)
    cells = rng.standard_normal((B, gy, gx, 4, N)).astype(np.float32)
    geo = dict(pos_idx=pos, sub_slices=subs, m=2, n=4, ty=ty, tx=tx)
    want_x = jref.fused_pre_engine_bwd_x_ref(jnp.asarray(g), jnp.asarray(ww), jnp.asarray(inv), _bt(),
                                             gy=gy, gx=gx, m2=4, **geo)
    want_w = jref.fused_pre_engine_bwd_w_ref(jnp.asarray(cells), jnp.asarray(g), jnp.asarray(inv), _bt(),
                                             m2=4, **geo)
    t = torch.from_numpy
    got_x = E.fused_engine_bwd_x_plain(t(g), t(ww), t(inv), gy=gy, gx=gx, stride=S, **geo)
    got_w = E.fused_engine_bwd_w_plain(t(cells), t(g), t(inv), stride=S, **geo)
    _close(got_x.numpy(), want_x)
    _close(got_w.numpy(), want_w)
    # the wrappers on CPU tensors are the plain versions, and count nothing
    before = (E.fused_engine_bwd_x.launches, E.fused_engine_bwd_w.launches)
    assert torch.equal(E.fused_engine_bwd_x(t(g), t(ww), t(inv), gy=gy, gx=gx, stride=S, **geo), got_x)
    assert torch.equal(E.fused_engine_bwd_w(t(cells), t(g), t(inv), stride=S, **geo), got_w)
    assert (E.fused_engine_bwd_x.launches, E.fused_engine_bwd_w.launches) == before
    # rows and columns the forward never reads get exactly zero
    assert not got_x[:, ty + 1:].any() and not got_x[:, :, tx + 1:].any()


@pytest.mark.parametrize("geom", ["k5s2", "k3s1"])
def test_bwd_plain_matches_pallas_interpret(geom):
    """The Pallas backward kernels themselves (interpret mode, tiny shape)."""
    td, pos, subs, inv, ty, tx = _geometry(geom)
    S = td.stride
    B, N, M = 1, 4, 3
    gy, gx = ty + 1, tx + 1
    rng = np.random.default_rng(11)
    g = rng.standard_normal((B, ty, tx, S * S * 4, M)).astype(np.float32)
    ww = rng.standard_normal((len(pos), N, M)).astype(np.float32)
    cells = rng.standard_normal((B, gy, gx, 4, N)).astype(np.float32)
    geo = dict(pos_idx=pos, sub_slices=subs, m=2, n=4, ty=ty, tx=tx)
    blk = dict(block_ty=2, block_n=8, block_m=8, interpret=True)
    want_x = jwd.winograd_fused_pre_engine_bwd_x(jnp.asarray(g), jnp.asarray(ww), jnp.asarray(inv), _bt(),
                                                 gy=gy, gx=gx, m2=4, **geo, **blk)
    want_w = jwd.winograd_fused_pre_engine_bwd_w(jnp.asarray(cells), jnp.asarray(g), jnp.asarray(inv), _bt(),
                                                 m2=4, **geo, **blk)
    t = torch.from_numpy
    _close(E.fused_engine_bwd_x_plain(t(g), t(ww), t(inv), gy=gy, gx=gx, stride=S, **geo).numpy(), want_x)
    _close(E.fused_engine_bwd_w_plain(t(cells), t(g), t(inv), stride=S, **geo).numpy(), want_w)


@pytest.mark.parametrize("mode", ["nhwc", "cells"])
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("act", ACTS)
def test_autograd_fn_matches_jax_vjp(act, affine, mode):
    """dcells, dww, dscale, dbias of the port's Function against jax.vjp of
    the JAX reference engine; the geometry rotates with the case."""
    geom = list(GEOMS)[(ACTS.index(act) + 2 * affine + (mode == "cells")) % len(GEOMS)]
    B, H, W, N, M = 2, 4, 5, 4, 5
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, H, W, N)).astype(np.float32)
    w = (0.5 * rng.standard_normal((GEOMS[geom][0],) * 2 + (N, M))).astype(np.float32)
    scale = (0.3 * rng.standard_normal(M) + 1.2).astype(np.float32) if affine else None
    bias = (0.2 * rng.standard_normal(M)).astype(np.float32) if affine else None
    jd, td = jtdc.DeconvDims(*GEOMS[geom]), DeconvDims(*GEOMS[geom])
    jp = jops.prepack(jnp.asarray(w), jd)
    jcells = jops.cells_from_image(jnp.asarray(x), jd)
    emit = mode == "cells"

    def jf(c, ww, sc, bi):
        return jops.winograd_deconv2d_cells(c, jops.PackedDeconv(ww, jp.inv), jd, (H, W), backend="ref",
                                            epilogue=act, scale=sc, bias=bi, emit_cells=emit)

    args = (jcells, jp.ww, None if scale is None else jnp.asarray(scale), None if bias is None else jnp.asarray(bias))
    y, vjp = jax.vjp(jf, *args)
    cot = rng.standard_normal(y.shape).astype(np.float32)
    want = vjp(jnp.asarray(cot))

    t = lambda a: None if a is None else torch.from_numpy(np.array(a)).requires_grad_()  # noqa: E731
    tc, tww, tsc, tbi = t(jcells), t(jp.ww), t(scale), t(bias)
    got_y = tops.winograd_deconv2d_cells(tc, tops.PackedDeconv(tww, torch.from_numpy(np.array(jp.inv))), td,
                                         (H, W), backend="cuda", epilogue=act, scale=tsc, bias=tbi,
                                         emit_cells=emit)
    if emit:  # JAX's ref cells output is the exact array too
        assert tuple(got_y.shape) == y.shape
    _close(got_y.detach().numpy(), y)
    leaves = [a for a in (tc, tww, tsc, tbi) if a is not None]
    grads = torch.autograd.grad(got_y, leaves, torch.from_numpy(cot))
    for got, w_ in zip(grads, [w_ for w_, a in zip(want, args) if a is not None]):
        _close(got.numpy(), w_)


def test_cuda_chained_training_backward_runs_each_bwd_wrapper_once_per_layer(monkeypatch):
    """A generator training backward through the cuda_chained impl calls
    ``fused_engine_bwd_x`` and ``fused_engine_bwd_w`` once per deconv layer
    (on CPU tensors they take the plain versions); the backward never runs
    the forward's plain version, as autograd through the ``ref`` backend
    would."""
    calls = {"x": 0, "w": 0, "plain_fwd": 0}
    real_x, real_w, real_plain = E.fused_engine_bwd_x, E.fused_engine_bwd_w, E.fused_engine_plain

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(E, "fused_engine_bwd_x", count("x", real_x))
    monkeypatch.setattr(E, "fused_engine_bwd_w", count("w", real_w))
    cfg = tzoo.tiny_dcgan("cuda_chained")
    p = TG.generator_init(cfg, seed=0, device="cpu")
    # the stem's weights want a gradient too, so every layer needs dcells
    leaves = [p[f"deconv{i}"]["ww"].requires_grad_() for i in range(cfg.n_deconv)] + [p["stem"]["w"].requires_grad_()]
    img, _ = TG.generator_apply(p, cfg, torch.randn(2, cfg.z_dim), training=True)
    assert calls["x"] == calls["w"] == 0
    monkeypatch.setattr(E, "fused_engine_plain", count("plain_fwd", real_plain))
    torch.autograd.grad(img.square().sum(), leaves)
    assert calls["x"] == calls["w"] == cfg.n_deconv
    assert calls["plain_fwd"] == 0


def test_bwd_wrappers_refuse_other_devices():
    td, pos, subs, inv, ty, tx = _geometry("k5s2")
    geo = dict(pos_idx=pos, sub_slices=subs, m=2, n=4, ty=ty, tx=tx, stride=2)
    g = torch.zeros((1, ty, tx, 16, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        E.fused_engine_bwd_x(g, torch.zeros((len(pos), 4, 3), device="meta"), torch.from_numpy(inv).to("meta"),
                             gy=ty + 1, gx=tx + 1, **geo)
    with pytest.raises(ValueError, match="cpu or cuda"):
        E.fused_engine_bwd_w(torch.zeros((1, ty + 1, tx + 1, 4, 4), device="meta"), g,
                             torch.from_numpy(inv).to("meta"), **geo)


def test_cells_window_mask_matches_jax():
    for args in [(6, 6, 2, 2, 8, 8), (5, 7, 2, 1, 7, 10), (3, 3, 2, 0, 6, 6)]:
        np.testing.assert_array_equal(tops.cells_window_mask(*args).numpy(), np.asarray(jops.cells_window_mask(*args)))


def test_chained_training_grads_equal_between_backends():
    """cuda_chained (Function + backward plain versions) and chained_ref
    (autograd through the forward's plain version) give the same trunk
    gradients on CPU."""
    cfg = tzoo.tiny_dcgan("cuda_chained")
    p = TG.generator_init(cfg, seed=1, device="cpu")
    z = torch.randn(2, cfg.z_dim, generator=torch.Generator().manual_seed(0))
    out = {}
    for impl in ("cuda_chained", "chained_ref"):
        q = {k: {kk: v.clone().requires_grad_() for kk, v in d.items()} for k, d in p.items()}
        img, _ = TG.generator_apply(q, dataclasses.replace(cfg, deconv_impl=impl), z, training=True)
        leaves = [q[f"deconv{i}"]["ww"] for i in range(cfg.n_deconv)] + [q["stem"]["w"]]
        out[impl] = torch.autograd.grad(img.square().sum(), leaves)
    for a, b in zip(out["cuda_chained"], out["chained_ref"]):
        _close(a.numpy(), b.numpy())
