"""Port parity of the 1D Winograd engine path (TPU kernels 8 and 9, and
kernels 4 and 5 at rank 1).

* The 1D layout: ``plan_1d`` counts over the reference's deconv1d
  geometries, the packed layouts and packing (exact / 1e-6), the cells.
* The baselines ``tdc_deconv1d`` and ``lax_deconv1d`` against JAX.
* The plain versions of the 1D engine (both out modes, four activations,
  scale and bias on and off, phases 1 and 2) against the JAX oracle
  ``conv1d_engine_ref`` and, at one small shape, the Pallas kernel in
  interpret mode.
* ``winograd_conv1d`` (K = 3, 4; causal, same, valid) and
  ``winograd_deconv1d`` against JAX ``backend="ref"``.
* ``Engine1dFn``'s gradients (``backend="cuda"`` on CPU tensors, which
  takes the wrappers' plain versions) against ``jax.vjp`` of the JAX ref
  path, and a tripwire that its backward runs the rank-1 kernel wrappers.
* The plain rank-1 kernels 4 and 5 against JAX ``engine_bwd_x_ref`` /
  ``engine_bwd_w_ref`` at m2 = 2.

Tolerance: atol ``1e-4 * max|ref| + 1e-5`` per array (fp32 sums in another
order), unless a line says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tdc as jtdc
from repro.kernels import engine as jeng
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import gan as jgan
from repro_torch.core import DeconvDims, decompose_weights_1d, plan_1d, tdc_deconv1d
from repro_torch.kernels import engine as E
from repro_torch.kernels import ops as tops
from repro_torch.models.gan import lax_deconv1d

# the audio decoder's K4S2 plus the reference's odd-kernel / odd-stride geometries
DECONV_GEOMS = [(4, 2, 1, 0), (4, 2, 0, 0), (3, 2, 1, 1), (6, 3, 2, 0)]
ACTS = ("none", "relu", "leaky_relu", "tanh")
t = torch.from_numpy


def _close(got, want, scale=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * np.abs(want).max() + 1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("geom", DECONV_GEOMS, ids=str)
def test_plan_1d_counts_match_jax(geom):
    want = jtdc.plan_1d(jtdc.DeconvDims(*geom))
    got = plan_1d(DeconvDims(*geom))
    assert got.taps_1d == want.taps_1d
    np.testing.assert_array_equal(got.nnz_winograd, want.nnz_winograd)
    np.testing.assert_array_equal(got.masks_winograd, want.masks_winograd)
    assert got.c_total == want.c_total
    if geom == (4, 2, 1, 0):  # K4S2: C(2) = 3 of n = 4 per sub-filter
        assert tuple(got.nnz_winograd) == (3, 3) and got.c_total == 6


@pytest.mark.parametrize("geom", DECONV_GEOMS, ids=str)
def test_packed_deconv1d_layout_and_pack_match_jax(geom):
    dims, jdims = DeconvDims(*geom), jtdc.DeconvDims(*geom)
    pos, subs, inv, keeps = tops.packed_deconv1d_layout(dims)
    jpos, jsubs, jinv, jkeeps = jops.packed_deconv1d_layout(jdims)
    assert (pos, subs, keeps) == (tuple(jpos), tuple(jsubs), jkeeps)
    np.testing.assert_array_equal(inv, jinv)
    w = _rng(1).standard_normal((geom[0], 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(decompose_weights_1d(t(w), dims).numpy(),
                                  np.asarray(jtdc.decompose_weights_1d(jnp.asarray(w), jdims)))
    _close(tops.pack_deconv1d_weights(t(w), dims).numpy(), jops.pack_deconv1d_weights(jnp.asarray(w), jdims),
           scale=1e-6)
    pk = tops.prepack_deconv1d(t(w), dims)
    assert pk.inv.dtype == torch.float32 and tuple(pk.inv.shape) == (len(pos), 2)


@pytest.mark.parametrize("K", [3, 4])
def test_conv1d_layout_and_pack_match_jax(K):
    pos, subs, inv, bt, n = tops.conv1d_layout(K)
    jpos, jsubs, jinv, jbt, jn = jops.conv1d_layout(K)
    assert (pos, subs, bt, n) == (tuple(jpos), tuple(jsubs), jbt, jn)
    np.testing.assert_array_equal(inv, jinv)
    w = _rng(2).standard_normal((K, 4, 6)).astype(np.float32)
    _close(tops.pack_conv1d_weights(t(w), K).numpy(), jops.pack_conv1d_weights(jnp.asarray(w), K), scale=1e-6)
    x = _rng(3).standard_normal((2, 9, 4)).astype(np.float32)
    np.testing.assert_array_equal(tops.conv1d_cells(t(x), 6, 2, n).numpy(),
                                  np.asarray(jops.conv1d_cells(jnp.asarray(x), 6, 2, n)))


# --------------------------------------------------------------- baselines
@pytest.mark.parametrize("geom", DECONV_GEOMS, ids=str)
def test_tdc_and_lax_deconv1d_match_jax(geom):
    dims, jdims = DeconvDims(*geom), jtdc.DeconvDims(*geom)
    x = _rng(4).standard_normal((2, 9, 4)).astype(np.float32)
    w = _rng(5).standard_normal((geom[0], 4, 6)).astype(np.float32)
    want = np.asarray(jgan.lax_deconv1d(jnp.asarray(x), jnp.asarray(w), jdims))
    _close(lax_deconv1d(t(x), t(w), dims).numpy(), want)
    _close(tdc_deconv1d(t(x), t(w), dims).numpy(), want)
    _close(tdc_deconv1d(t(x), t(w), dims).numpy(), jtdc.tdc_deconv1d(jnp.asarray(x), jnp.asarray(w), jdims))


# ------------------------------------------------------ the 1D engine (8, 9)
def _engine_case(geom, phases=1, B=2, ty=7, N=8, M=5, seed=0):
    """Cells, packed weights and the layout of a deconv1d geometry
    (phases 1) or of one sub-filter over ``phases`` phases of F(2,3)
    positions (a phase-decomposed conv)."""
    rng = _rng(seed)
    if phases == 1:
        pos, subs, inv, _ = tops.packed_deconv1d_layout(DeconvDims(*geom))
        stride = geom[1]
    else:
        n = 4
        pos = tuple(range(phases * n))
        subs = ((0, len(pos)),)
        inv = np.tile(np.asarray(jops.conv1d_layout(3)[2]), (phases, 1))
        stride = 1
    C = len(pos)
    cells = rng.standard_normal((B, ty + 1, phases * 2, N)).astype(np.float32)
    ww = rng.standard_normal((C, N, M)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(M)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(M)).astype(np.float32)
    kw = dict(pos_idx=tuple(pos), sub_slices=tuple(subs), m=2, n=4, ty=ty, phases=phases)
    return cells, ww, np.asarray(inv, np.float32), scale, bias, kw, stride


def _bt23():
    return tops.conv1d_layout(3)[3]


@pytest.mark.parametrize("geom,phases", [((4, 2, 1, 0), 1), ((6, 3, 2, 0), 1), ((3, 2, 1, 1), 1), (None, 2)],
                         ids=["k4s2", "k6s3", "k3s2op1", "phases2"])
def test_engine1d_plain_matches_jax_oracle(geom, phases):
    cells, ww, inv, scale, bias, kw, S = _engine_case(geom, phases)
    j = jnp.asarray
    want = np.asarray(jref.conv1d_engine_ref(j(cells), j(ww), j(inv), _bt23(), stride=S, **kw))
    got = E.winograd_conv1d_fused_engine_plain(t(cells), t(ww), t(inv), _bt23(), out_mode="nlc", stride=S, **kw)
    _close(got.numpy(), want)
    # scratch: the same products before the interleave
    scr = E.winograd_conv1d_fused_engine_plain(t(cells), t(ww), t(inv), _bt23(), out_mode="scratch", **kw)
    B, ty = cells.shape[0], kw["ty"]
    assert tuple(scr.shape) == (B, ty, len(kw["sub_slices"]) * 2, ww.shape[2])
    _close(scr.reshape(B, ty, S, 2, -1).permute(0, 1, 3, 2, 4).reshape(B, ty * 2 * S, -1).numpy(), want)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("affine", [True, False])
def test_engine1d_epilogue_matches_jax(act, affine):
    cells, ww, inv, scale, bias, kw, S = _engine_case((4, 2, 1, 0), seed=ACTS.index(act))
    j = jnp.asarray
    y = np.asarray(jref.conv1d_engine_ref(j(cells), j(ww), j(inv), _bt23(), stride=S, **kw))
    want = (y * scale + bias) if affine else y
    want = {"none": want, "relu": np.maximum(want, 0), "leaky_relu": np.where(want >= 0, want, 0.2 * want),
            "tanh": np.tanh(want)}[act]
    sb = dict(scale=t(scale), bias=t(bias)) if affine else {}
    before = (E.winograd_conv1d_fused_engine.launches, E.winograd_conv1d_fused_engine.scratch_launches)
    got = E.winograd_conv1d_fused_engine(t(cells), t(ww), t(inv), _bt23(), activation=act, stride=S, **sb, **kw)
    _close(got.numpy(), want)
    # the wrapper on CPU tensors is the plain version and counts nothing
    plain = E.winograd_conv1d_fused_engine_plain(t(cells), t(ww), t(inv), _bt23(), activation=act, stride=S,
                                                 **sb, **kw)
    assert torch.equal(got, plain)
    assert (E.winograd_conv1d_fused_engine.launches, E.winograd_conv1d_fused_engine.scratch_launches) == before


@pytest.mark.parametrize("out_mode", ["scratch", "nlc"])
def test_engine1d_plain_matches_pallas_interpret(out_mode):
    """The Pallas kernel itself, in interpret mode with the reference's
    interpret blocks, at one small K4S2 shape (nlc with the epilogue)."""
    cells, ww, inv, scale, bias, kw, S = _engine_case((4, 2, 1, 0), ty=5, N=8, M=8, seed=9)
    epi = dict(activation="tanh", scale=scale, bias=bias, stride=S) if out_mode == "nlc" else {}
    j = jnp.asarray
    want = jeng.winograd_conv1d_fused_engine(
        j(cells), j(ww), j(inv), _bt23(), interpret=True, out_mode=out_mode, **jops.INTERPRET_BLOCKS_1D, **kw,
        **{k: (j(v) if isinstance(v, np.ndarray) else v) for k, v in epi.items()})
    got = E.winograd_conv1d_fused_engine_plain(t(cells), t(ww), t(inv), _bt23(), out_mode=out_mode, **kw,
                                               **{k: (t(v) if isinstance(v, np.ndarray) else v)
                                                  for k, v in epi.items()})
    _close(got.numpy(), np.asarray(want))


# -------------------------------------------------------------- entry points
@pytest.mark.parametrize("K,padding", [(3, "causal"), (4, "causal"), (3, "same"), (4, "same"), (4, "valid")])
def test_winograd_conv1d_matches_jax_ref(K, padding):
    x = _rng(10 + K).standard_normal((2, 13, 8)).astype(np.float32)
    w = _rng(20 + K).standard_normal((K, 8, 7)).astype(np.float32)
    want = np.asarray(jops.winograd_conv1d(jnp.asarray(x), jnp.asarray(w), padding=padding, backend="ref"))
    for backend in ("ref", "cuda"):
        _close(tops.winograd_conv1d(t(x), t(w), padding=padding, backend=backend).numpy(), want)
    pk = tops.prepack_conv1d(t(w), K)
    assert torch.equal(tops.winograd_conv1d_packed(t(x), pk, K, padding=padding, backend="ref"),
                       tops.winograd_conv1d(t(x), t(w), padding=padding, backend="ref"))


@pytest.mark.parametrize("geom", DECONV_GEOMS, ids=str)
def test_winograd_deconv1d_matches_jax_ref(geom):
    dims, jdims = DeconvDims(*geom), jtdc.DeconvDims(*geom)
    x = _rng(30).standard_normal((2, 9, 8)).astype(np.float32)
    w = _rng(31).standard_normal((geom[0], 8, 6)).astype(np.float32)
    want = np.asarray(jops.winograd_deconv1d(jnp.asarray(x), jnp.asarray(w), jdims, backend="ref"))
    assert want.shape == (2, dims.out_size(9), 6)
    for backend in ("ref", "cuda"):
        _close(tops.winograd_deconv1d(t(x), t(w), dims, backend=backend).numpy(), want)
    with pytest.raises(ValueError, match="backend"):
        tops.winograd_deconv1d(t(x), t(w), dims, backend="pallas")


# -------------------------------------------------------------- gradients
def _jax_grads(fn, x, w, g):
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _torch_grads(fn, x, w, g):
    xt, wt = t(x).requires_grad_(True), t(w).requires_grad_(True)
    return [a.numpy() for a in torch.autograd.grad((fn(xt, wt) * t(g)).sum(), (xt, wt))]


@pytest.mark.parametrize("geom", [(4, 2, 1, 0), (3, 2, 1, 1), (6, 3, 2, 0)], ids=str)
def test_engine1dfn_deconv1d_grads_match_jax_vjp(geom):
    dims, jdims = DeconvDims(*geom), jtdc.DeconvDims(*geom)
    x = _rng(40).standard_normal((2, 7, 8)).astype(np.float32)
    w = _rng(41).standard_normal((geom[0], 8, 5)).astype(np.float32)
    g = _rng(42).standard_normal((2, dims.out_size(7), 5)).astype(np.float32)
    want = _jax_grads(lambda a, b: jops.winograd_deconv1d(a, b, jdims, backend="ref"), x, w, g)
    got = _torch_grads(lambda a, b: tops.winograd_deconv1d(a, b, dims, backend="cuda"), x, w, g)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("K,padding", [(3, "causal"), (4, "same"), (4, "valid")])
def test_engine1dfn_conv1d_grads_match_jax_vjp(K, padding):
    x = _rng(50).standard_normal((2, 11, 4)).astype(np.float32)
    w = _rng(51).standard_normal((K, 4, 6)).astype(np.float32)
    LO = 11 if padding != "valid" else 11 - K + 1
    g = _rng(52).standard_normal((2, LO, 6)).astype(np.float32)
    want = _jax_grads(lambda a, b: jops.winograd_conv1d(a, b, padding=padding, backend="ref"), x, w, g)
    got = _torch_grads(lambda a, b: tops.winograd_conv1d(a, b, padding=padding, backend="cuda"), x, w, g)
    for a, b in zip(got, want):
        _close(a, b)


def test_engine1dfn_runs_the_kernel_wrappers(monkeypatch):
    """Tripwire: ``backend="cuda"`` reaches the 1D engine's wrapper forward
    and the rank-1 kernel 4 and 5 wrappers backward, once each (on a CPU
    tensor each wrapper then takes its plain version)."""
    calls = []

    def spy(name):
        real = getattr(E, name)

        def f(*a, **k):
            calls.append(name)
            return real(*a, **k)
        return f

    names = ("winograd_conv1d_fused_engine", "domain_engine_bwd_x", "domain_engine_bwd_w")
    for name in names:
        monkeypatch.setattr(E, name, spy(name))
    dims = DeconvDims(4, 2, 1, 0)
    x = torch.randn((1, 5, 4), requires_grad=True)
    pk = tops.prepack_deconv1d(torch.randn((4, 4, 3)), dims)
    ww = pk.ww.clone().requires_grad_(True)
    y = tops.winograd_deconv1d_packed(x, tops.PackedConv1d(ww, pk.inv), dims, backend="cuda")
    torch.autograd.grad(y.sum(), (x, ww))
    assert calls == list(names)
    calls.clear()
    tops.winograd_deconv1d_packed(x, tops.PackedConv1d(ww, pk.inv), dims, backend="ref")
    assert calls == []


# ------------------------------------------------------ rank-1 kernels 4, 5
@pytest.mark.parametrize("geom,n2", [((4, 2, 1, 0), 4), ((6, 3, 2, 0), 4), (None, 5)], ids=["k4s2", "k6s3", "conv_k4"])
def test_rank1_domain_bwd_plain_matches_jax(geom, n2):
    if geom is None:
        pos, subs, inv, _, _ = tops.conv1d_layout(4)
    else:
        pos, subs, inv, _ = tops.packed_deconv1d_layout(DeconvDims(*geom))
    rng = _rng(60)
    T, N, M = 13, 8, 6
    g = rng.standard_normal((T, len(subs) * 2, M)).astype(np.float32)
    ww = rng.standard_normal((len(pos), N, M)).astype(np.float32)
    xw = rng.standard_normal((T, n2, N)).astype(np.float32)
    kw = dict(pos_idx=tuple(pos), sub_slices=tuple(subs), m2=2)
    j = jnp.asarray
    _close(E.domain_engine_bwd_x_plain(t(g), t(ww), t(inv), n2=n2, **kw).numpy(),
           jref.engine_bwd_x_ref(j(g), j(ww), j(inv), n2=n2, **kw))
    _close(E.domain_engine_bwd_w_plain(t(xw), t(g), t(inv), **kw).numpy(),
           jref.engine_bwd_w_ref(j(xw), j(g), j(inv), **kw))
    counters = [(f, a) for f in (E.domain_engine_bwd_x, E.domain_engine_bwd_w) for a in ("launches", "rank1_launches")]
    before = [getattr(f, a) for f, a in counters]
    assert torch.equal(E.domain_engine_bwd_x(t(g), t(ww), t(inv), n2=n2, **kw),
                       E.domain_engine_bwd_x_plain(t(g), t(ww), t(inv), n2=n2, **kw))
    assert torch.equal(E.domain_engine_bwd_w(t(xw), t(g), t(inv), **kw),
                       E.domain_engine_bwd_w_plain(t(xw), t(g), t(inv), **kw))
    assert [getattr(f, a) for f, a in counters] == before


def test_conv1d_backward_compositions_match_jax():
    """``winograd_conv1d_fused_bwd_x`` / ``_bwd_w`` (the rank-1 kernels plus
    host code) against the reference's, at K4S2 and at phases 2."""
    for geom, phases in (((4, 2, 1, 0), 1), (None, 2)):
        cells, ww, inv, _, _, kw, S = _engine_case(geom, phases, seed=70)
        B, ty = cells.shape[0], kw["ty"]
        g = _rng(71).standard_normal((B, ty, len(kw["sub_slices"]) * 2, ww.shape[2])).astype(np.float32)
        j = jnp.asarray
        blocks = dict(block_t=16, block_n=8, block_m=8, interpret=True)
        want_x = jeng.winograd_conv1d_fused_bwd_x(j(g), j(ww), j(inv), _bt23(), gy=cells.shape[1], **blocks, **kw)
        want_w = jeng.winograd_conv1d_fused_bwd_w(j(cells), j(g), j(inv), _bt23(), **blocks, **kw)
        for fn in (E.winograd_conv1d_fused_bwd_x, E.winograd_conv1d_fused_bwd_x_plain):
            _close(fn(t(g), t(ww), t(inv), _bt23(), gy=cells.shape[1], **kw).numpy(), want_x)
        for fn in (E.winograd_conv1d_fused_bwd_w, E.winograd_conv1d_fused_bwd_w_plain):
            _close(fn(t(cells), t(g), t(inv), _bt23(), **kw).numpy(), want_w)
