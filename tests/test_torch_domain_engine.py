"""Port parity of the per-layer engine path: the unfused engine (TPU kernels
1, 4, 5) and the fused pre-PE engine's scratch mode (kernel 2).

* The plain versions (``domain_engine_plain``, ``domain_engine_bwd_x_plain``,
  ``domain_engine_bwd_w_plain``, ``fused_engine_plain`` in scratch mode)
  against the JAX oracles ``engine_ref``, ``engine_bwd_x_ref``,
  ``engine_bwd_w_ref`` and ``fused_pre_engine_ref`` over K5S2, K4S2, K3S1
  and K2S3, and against the Pallas kernels themselves in interpret mode at
  one small K4S2 shape.
* The autograd Functions (``EngineFn``, ``FusedPreFn``: ``backend="cuda"``
  on CPU tensors, which takes the plain versions) against ``jax.vjp`` of the
  JAX per-layer path (``winograd_deconv2d_packed``, ``backend="ref"``) and
  of the JAX oracles.
* A tripwire: the ``backend="cuda"`` path reaches the ``engine.py`` wrappers
  and never a ``ref.py`` function directly; its backward never runs the
  forward's plain version.

Tolerance: atol ``1e-4 * max|ref| + 1e-5`` per array (fp32 sums in another
order).
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
from repro.kernels import winograd_deconv as jwd
from repro_torch.core import DeconvDims
from repro_torch.kernels import engine as E
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

GEOMS = {"k5s2": (5, 2, 2, 1), "k4s2": (4, 2, 1, 0), "k3s1": (3, 1, 1, 0), "k2s3": (2, 3, 0, 0)}
t = torch.from_numpy


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-5)


def _bt():
    return tuple(tuple(float(v) for v in row) for row in jget_transform(2, 3).BT)


def _raw(geom, T=11, N=6, M=5, seed=0):
    """Random xw, packed weights, cotangent and the layout of ``geom``."""
    pos, subs, inv, _ = tops.packed_layout(DeconvDims(*GEOMS[geom]))
    rng = np.random.default_rng(seed)
    S2 = len(subs)
    xw = rng.standard_normal((T, 16, N)).astype(np.float32)
    ww = rng.standard_normal((len(pos), N, M)).astype(np.float32)
    g = rng.standard_normal((T, S2 * 4, M)).astype(np.float32)
    return xw, ww, g, inv, dict(pos_idx=pos, sub_slices=subs, m2=4)


@pytest.mark.parametrize("geom", list(GEOMS))
def test_domain_plain_matches_jax_oracles(geom):
    xw, ww, g, inv, kw = _raw(geom)
    j = jnp.asarray
    _close(E.domain_engine_plain(t(xw), t(ww), t(inv), **kw).numpy(), jref.engine_ref(j(xw), j(ww), j(inv), **kw))
    _close(E.domain_engine_bwd_x_plain(t(g), t(ww), t(inv), n2=16, **kw).numpy(),
           jref.engine_bwd_x_ref(j(g), j(ww), j(inv), n2=16, **kw))
    _close(E.domain_engine_bwd_w_plain(t(xw), t(g), t(inv), **kw).numpy(),
           jref.engine_bwd_w_ref(j(xw), j(g), j(inv), **kw))
    # the wrappers on CPU tensors are the plain versions, and count nothing
    counters = (E.domain_engine, E.domain_engine_bwd_x, E.domain_engine_bwd_w)
    before = [f.launches for f in counters]
    assert torch.equal(E.domain_engine(t(xw), t(ww), t(inv), **kw), E.domain_engine_plain(t(xw), t(ww), t(inv), **kw))
    dx = E.domain_engine_bwd_x(t(g), t(ww), t(inv), n2=16, **kw)
    assert torch.equal(dx, E.domain_engine_bwd_x_plain(t(g), t(ww), t(inv), n2=16, **kw))
    assert torch.equal(E.domain_engine_bwd_w(t(xw), t(g), t(inv), **kw),
                       E.domain_engine_bwd_w_plain(t(xw), t(g), t(inv), **kw))
    assert [f.launches for f in counters] == before
    # Winograd positions that no packed position keeps get exactly zero
    kept = sorted(set(kw["pos_idx"]))
    unkept = [p for p in range(16) if p not in kept]
    assert not dx[:, unkept].any()


@pytest.mark.parametrize("geom", list(GEOMS))
def test_fused_scratch_plain_matches_jax_oracle(geom):
    td = DeconvDims(*GEOMS[geom])
    pos, subs, inv, _ = tops.packed_layout(td)
    B, H, W, N, M = 2, 3, 5, 4, 6
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, H, W, N)).astype(np.float32)
    ww = rng.standard_normal((len(pos), N, M)).astype(np.float32)
    cells = tops.cells_from_image(t(x), td)
    ty, tx = -(-td.j_extent(H) // 2), -(-td.j_extent(W) // 2)
    geo = dict(pos_idx=pos, sub_slices=subs, m=2, n=4, ty=ty, tx=tx)
    want = jref.fused_pre_engine_ref(jnp.asarray(cells.numpy()), jnp.asarray(ww), jnp.asarray(inv), _bt(), m2=4,
                                     **geo)
    kw = dict(stride=td.stride, padding=td.padding, out_h=td.out_size(H), out_w=td.out_size(W), out_mode="scratch",
              **geo)
    before = (E.fused_engine.launches, E.fused_engine.scratch_launches)
    got = E.fused_engine(cells, t(ww), t(inv), **kw)
    assert (E.fused_engine.launches, E.fused_engine.scratch_launches) == before
    assert got.shape == (B, ty, tx, td.stride**2 * 4, M)
    _close(got.numpy(), want)


def test_plain_versions_match_pallas_interpret():
    """The Pallas kernels themselves (interpret mode) at one small K4S2 shape:
    kernels 1, 4, 5 on raw matrices, and kernel 2 (the scratch out mode) on
    cells; the Pallas scratch output is block-padded past the exact array."""
    xw, ww, g, inv, kw = _raw("k4s2", T=10, N=5, M=3, seed=2)
    j = jnp.asarray
    blk = dict(interpret=True, block_t=8, block_n=8, block_m=8)
    _close(E.domain_engine_plain(t(xw), t(ww), t(inv), **kw).numpy(),
           jwd.winograd_domain_engine(j(xw), j(ww), j(inv), **kw, **blk))
    _close(E.domain_engine_bwd_x_plain(t(g), t(ww), t(inv), n2=16, **kw).numpy(),
           jwd.winograd_domain_engine_bwd_x(j(g), j(ww), j(inv), n2=16, **kw, **blk))
    _close(E.domain_engine_bwd_w_plain(t(xw), t(g), t(inv), **kw).numpy(),
           jwd.winograd_domain_engine_bwd_w(j(xw), j(g), j(inv), **kw, **blk))

    td = DeconvDims(*GEOMS["k4s2"])
    B, H, W = 1, 3, 4
    x = np.random.default_rng(3).standard_normal((B, H, W, 5)).astype(np.float32)
    cells = tops.cells_from_image(t(x), td)
    ty, tx = -(-td.j_extent(H) // 2), -(-td.j_extent(W) // 2)
    geo = dict(pos_idx=kw["pos_idx"], sub_slices=kw["sub_slices"], m=2, n=4, ty=ty, tx=tx)
    want = np.asarray(jwd.winograd_fused_pre_engine(j(cells.numpy()), j(ww), j(inv), _bt(), m2=4, out_mode="scratch",
                                                    interpret=True, block_ty=2, block_n=8, block_m=8, **geo))
    got = E.fused_engine_plain(cells, t(ww), t(inv), stride=2, padding=td.padding, out_h=td.out_size(H),
                               out_w=td.out_size(W), out_mode="scratch", **geo).numpy()
    _close(got, want[:B, :ty, :tx, :, :3])
    rest = want.copy()
    rest[:B, :ty, :tx, :, :3] = 0
    assert not rest.any()


def test_engine_fn_matches_jax_vjp_of_the_oracle():
    """EngineFn's dxw and dww against jax.vjp of JAX engine_ref."""
    xw, ww, g, inv, kw = _raw("k5s2", T=9, N=4, M=3, seed=4)
    _, vjp = jax.vjp(lambda a, b: jref.engine_ref(a, b, jnp.asarray(inv), **kw), jnp.asarray(xw), jnp.asarray(ww))
    want_x, want_w = vjp(jnp.asarray(g))
    txw, tww = t(xw).requires_grad_(), t(ww).requires_grad_()
    y = tops.EngineFn.apply(txw, tww, t(inv), kw)
    got_x, got_w = torch.autograd.grad(y, (txw, tww), t(g))
    _close(got_x.numpy(), want_x)
    _close(got_w.numpy(), want_w)


@pytest.mark.parametrize("fuse_pre", [False, True], ids=["EngineFn", "FusedPreFn"])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_per_layer_grads_match_jax_vjp(geom, fuse_pre):
    """dx and dww of ``winograd_deconv2d_packed`` (backend="cuda": the
    Function on CPU tensors) against jax.vjp of JAX winograd_deconv2d_packed
    with backend="ref", from the same packed weights."""
    B, H, W, N, M = 2, 4, 3, 4, 5
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, H, W, N)).astype(np.float32)
    w = (0.5 * rng.standard_normal((GEOMS[geom][0],) * 2 + (N, M))).astype(np.float32)
    jd, td = jtdc.DeconvDims(*GEOMS[geom]), DeconvDims(*GEOMS[geom])
    jp = jops.prepack(jnp.asarray(w), jd)
    y, vjp = jax.vjp(lambda a, b: jops.winograd_deconv2d_packed(a, jops.PackedDeconv(b, jp.inv), jd, backend="ref",
                                                                fuse_pre=fuse_pre), jnp.asarray(x), jp.ww)
    cot = rng.standard_normal(y.shape).astype(np.float32)
    want_x, want_w = vjp(jnp.asarray(cot))
    tx_, tww = t(x).requires_grad_(), t(np.array(jp.ww)).requires_grad_()
    got = tops.winograd_deconv2d_packed(tx_, tops.PackedDeconv(tww, t(np.array(jp.inv))), td, fuse_pre=fuse_pre)
    _close(got.detach().numpy(), y)
    got_x, got_w = torch.autograd.grad(got, (tx_, tww), t(cot))
    _close(got_x.numpy(), want_x)
    _close(got_w.numpy(), want_w)


@pytest.mark.parametrize("fuse_pre", [False, True], ids=["unfused", "fused_pre"])
def test_cuda_backend_reaches_the_wrappers_never_ref_directly(monkeypatch, fuse_pre):
    """Every ref.py contraction that the backend="cuda" path runs is called
    from inside an engine.py wrapper; the forward runs one wrapper, the
    backward each backward wrapper once and never the forward's plain
    version (as autograd through the ref backend would)."""
    inside = [0]
    calls = {}

    def wrap(name, fn):
        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            inside[0] += 1
            try:
                return fn(*a, **k)
            finally:
                inside[0] -= 1
        return wrapped

    def tripwire(name, fn):
        def guarded(*a, **k):
            if not inside[0]:
                raise AssertionError(f"ref.{name} called outside an engine wrapper")
            return fn(*a, **k)
        return guarded

    fwd, bwd = ("fused_engine", ("fused_engine_bwd_x", "fused_engine_bwd_w")) if fuse_pre else \
        ("domain_engine", ("domain_engine_bwd_x", "domain_engine_bwd_w"))
    for name in (fwd, *bwd):
        monkeypatch.setattr(E, name, wrap(name, getattr(E, name)))
    for name in ("engine_ref", "engine_bwd_x_ref", "engine_bwd_w_ref", "fused_pre_engine_ref",
                 "fused_pre_engine_bwd_x_ref", "fused_pre_engine_bwd_w_ref"):
        monkeypatch.setattr(tref, name, tripwire(name, getattr(tref, name)))
    td = DeconvDims(*GEOMS["k4s2"])
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 3, 4, 4), generator=g, requires_grad=True)
    packed = tops.prepack(torch.randn((4, 4, 4, 3), generator=g), td)
    ww = packed.ww.clone().requires_grad_()
    y = tops.winograd_deconv2d_packed(x, tops.PackedDeconv(ww, packed.inv), td, fuse_pre=fuse_pre)
    assert calls == {fwd: 1}
    def forward_plain(*a, **k):
        raise AssertionError("the backward ran the forward's plain version")

    monkeypatch.setattr(E, "fused_engine_plain" if fuse_pre else "domain_engine_plain", forward_plain)
    dx, dw = torch.autograd.grad(y.square().sum(), (x, ww))
    assert calls == {fwd: 1, bwd[0]: 1, bwd[1]: 1}
    assert dx.shape == x.shape and dw.shape == ww.shape


def test_domain_wrappers_refuse_other_devices():
    xw, ww, g, inv, kw = _raw("k5s2")
    meta = lambda a: t(a).to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="cpu or cuda"):
        E.domain_engine(meta(xw), meta(ww), meta(inv), **kw)
    with pytest.raises(ValueError, match="cpu or cuda"):
        E.domain_engine_bwd_x(meta(g), meta(ww), meta(inv), n2=16, **kw)
    with pytest.raises(ValueError, match="cpu or cuda"):
        E.domain_engine_bwd_w(meta(xw), meta(g), meta(inv), **kw)
