"""Port parity of the LM stack's SSM modules: ``ssd_chunked`` and
``ssd_ref``, the Mamba2 block's prefill (output, cache, gradients) and its
decode steps, and the causal conv "direct" and "engine" (on CPU tensors the
1D engine's plain version) with and without a carried tail.  The same numpy
inputs and JAX's own parameters go through both packages.

Tolerances: forward atol 1e-5 / rtol 1e-4; gradients 1e-4 of the largest
magnitude plus 1e-5 (ROADMAP §3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_pair import FWD, close_grads, dot, grads, jax_vjp, jit, leaf_params, to_t
from repro.configs import base as jbase
from repro.models import ssm as JS
from repro_torch.configs import base as tbase
from repro_torch.models import ssm as TS


# --------------------------------------------------------------------- SSD
def _ssd_case(seed, B=2, T=16, H=3, P=4, N=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, P)).astype(np.float32),
            (np.abs(rng.standard_normal((B, T, H))) * 0.5).astype(np.float32),
            (-(np.abs(rng.standard_normal(H)) + 0.1)).astype(np.float32),
            rng.standard_normal((B, T, N)).astype(np.float32), rng.standard_normal((B, T, N)).astype(np.float32))


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_and_ref(chunk):
    args = _ssd_case(chunk)
    (jy, jh), ct, jg = jax_vjp(lambda *a: JS.ssd_chunked(*a, chunk), args)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    ty, th = TS.ssd_chunked(*targs, chunk)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), **FWD)
    dot((ty, th), ct).backward()
    close_grads([a.grad for a in targs], jg)
    np.testing.assert_allclose(TS.ssd_ref(*map(torch.from_numpy, args)).numpy(),
                               np.asarray(JS.ssd_ref(*map(jnp.asarray, args))), **FWD)


SPEC = dict(d_state=8, d_conv=4, expand=2, head_dim=4, chunk=8)


@pytest.fixture(scope="module")
def mamba():
    spec_j, spec_t = jbase.SSMSpec(**SPEC), tbase.SSMSpec(**SPEC)
    p = jax.tree.map(np.asarray, JS.ssm_init(jax.random.PRNGKey(0), 8, spec_j))
    rng = np.random.default_rng(5)
    for conv in ("conv_x", "conv_B", "conv_C"):  # non-zero conv biases
        p[conv]["b"] = (0.1 * rng.standard_normal(p[conv]["b"].shape)).astype(np.float32)
    x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    return spec_j, spec_t, p, x


@pytest.mark.parametrize("impl", ["direct", "engine"])
def test_ssm_prefill_and_decode(mamba, impl):
    """Prefill (T = 12, chunk 8: padded) output, cache and gradients, then
    decode steps continuing from a prefill's cache, against JAX's (JAX's
    "engine" conv runs its Pallas kernel in interpret mode)."""
    spec_j, spec_t, p, x = mamba
    JS.set_conv_impl("direct" if impl == "direct" else "engine_interpret")
    TS.set_conv_impl(impl)
    try:
        (jy, jc), ct, jg = jax_vjp(lambda pp, xx: JS.ssm_prefill(pp, xx, spec_j), (p, x))
        tp, tx = leaf_params(to_t(p)), torch.from_numpy(x).requires_grad_(True)
        ty, tc = TS.ssm_prefill(tp, tx, spec_t)
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **FWD)
        dot((ty, tuple(tc)), (ct[0], tuple(ct[1]))).backward()
        close_grads({"p": grads(tp), "x": tx.grad}, {"p": jg[0], "x": jg[1]})
        # decode from the cache of the first 8 tokens
        _, jcache = jit(lambda pp, xx: JS.ssm_prefill(pp, xx, spec_j))(p, x[:, :8])
        jstep = jit(lambda pp, xx, c: JS.ssm_decode_step(pp, xx, c, spec_j))
        with torch.no_grad():
            _, tcache = TS.ssm_prefill(to_t(p), torch.from_numpy(x[:, :8]), spec_t)
            for t in range(8, 12):
                jy1, jcache = jstep(p, x[:, t : t + 1], jcache)
                ty1, tcache = TS.ssm_decode_step(to_t(p), torch.from_numpy(x[:, t : t + 1]), tcache, spec_t)
                np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), **FWD)
                for a, b in zip(tcache, jcache):
                    np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)
        cache0 = TS.ssm_cache_init(2, 8, spec_t)
        assert [tuple(a.shape) for a in cache0] == [a.shape for a in JS.ssm_cache_init(2, 8, spec_j)]
    finally:
        JS.set_conv_impl("direct")
        TS.set_conv_impl("direct")


@pytest.mark.parametrize("impl", ["direct", "engine", "engine_interpret"])
@pytest.mark.parametrize("init_state", [False, True])
def test_causal_conv(mamba, impl, init_state):
    """The causal conv with and without a carried tail, forward and
    gradients in x, the taps and the bias.  "engine" on CPU tensors and the
    port's "engine_interpret" are the plain 1D engine."""
    _, _, p, x = mamba
    conv = {"w": p["conv_x"]["w"][:, :8], "b": p["conv_x"]["b"][:8]}
    st = np.random.default_rng(8).standard_normal((2, 3, 8)).astype(np.float32) if init_state else None
    JS.set_conv_impl("direct")
    TS.set_conv_impl(impl)
    try:
        (jy, jtail), ct, jg = jax_vjp(
            lambda c, xx: JS._causal_conv(xx, c, None if st is None else jnp.asarray(st)), (conv, x))
        tconv, tx = leaf_params(to_t(conv)), torch.from_numpy(x).requires_grad_(True)
        ty, ttail = TS._causal_conv(tx, tconv, None if st is None else torch.from_numpy(st))
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD)
        np.testing.assert_array_equal(ttail.detach().numpy(), np.asarray(jtail))
        dot((ty, ttail), ct).backward()
        close_grads({"c": grads(tconv), "x": tx.grad}, {"c": jg[0], "x": jg[1]})
    finally:
        TS.set_conv_impl("direct")


def test_set_conv_impl_refuses_other_names():
    with pytest.raises(ValueError):
        TS.set_conv_impl("pallas")
    assert TS._CONV_IMPL == "direct"


def test_ssd_chunked_bf16_operands():
    """``bf16_matmul``: the einsums on bf16-rounded operands with fp32
    accumulation, as the reference's ``preferred_element_type`` gives."""
    args = _ssd_case(11)
    jy, jh = jit(lambda *a: JS.ssd_chunked(*a, 8, bf16_matmul=True))(*args)
    ty, th = TS.ssd_chunked(*map(torch.from_numpy, args), 8, bf16_matmul=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FWD)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **FWD)
    y32, _ = TS.ssd_chunked(*map(torch.from_numpy, args), 8)
    assert not torch.allclose(ty, y32, atol=1e-4)  # the rounding is there
