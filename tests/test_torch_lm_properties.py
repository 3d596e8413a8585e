"""Properties of both packages' LM stacks, not faults (ROADMAP §3,
"properties of both packages"); each test shows the property in JAX and in
the port on the same inputs.

* ``ssd_chunked`` computes ``exp(cum_i - cum_j)`` for every (i, j) of a
  chunk before it masks j > i.  At Mamba2-780m's 48 heads (A = -1..-48),
  its chunk of 256 and its init's dt = 0.01, the entries above the
  diagonal reach 0.01 * 48 * 255 = 122 > 88.7, where fp32's exp overflows:
  the forward is finite (the mask drops the infinities), but the gradient
  of dt is not.  At chunk 128 (at most 61) every gradient is finite.
* The MoE's capacity is a function of the batch (C = S k cf / E), so which
  assignments are dropped depends on what else is in the batch.  On one
  shared batch the port drops exactly the assignments JAX drops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import moe as JMoE
from repro.models import ssm as JS
from repro_torch.configs import base as tbase
from repro_torch.models import moe as TMoE
from repro_torch.models import ssm as TS

H, T, P, N = 48, 256, 2, 4


def _ssd_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, T, H, P)).astype(np.float32)
    dt = np.full((1, T, H), 0.01, np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)
    Bm, Cm = (rng.standard_normal((1, T, N)).astype(np.float32) for _ in range(2))
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("chunk", [256, 128])
def test_ssd_dt_gradient_overflows_at_the_published_chunk(chunk):
    args = _ssd_inputs()

    def jloss(x, dt, Bm, Cm):
        y, _ = JS.ssd_chunked(x, dt, jnp.asarray(args[2]), Bm, Cm, chunk)
        return jnp.sum(y**2), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(a) for a in (args[0], args[1], args[3], args[4])))
    tx, tdt, tB, tC = (torch.from_numpy(a).requires_grad_(True) for a in (args[0], args[1], args[3], args[4]))
    ty, _ = TS.ssd_chunked(tx, tdt, torch.from_numpy(args[2]), tB, tC, chunk)
    torch.sum(ty**2).backward()
    assert np.isfinite(np.asarray(jy)).all() and torch.isfinite(ty).all()
    for name, j, t in zip(("x", "dt", "B", "C"), jg, (tx.grad, tdt.grad, tB.grad, tC.grad)):
        j_finite, t_finite = bool(np.isfinite(np.asarray(j)).all()), bool(torch.isfinite(t).all())
        assert j_finite == t_finite, name  # the property is both packages'
        assert j_finite == (chunk == 128 or name != "dt"), (name, chunk)


def test_moe_drops_the_same_assignments_and_they_depend_on_the_batch():
    E, k, cf = 4, 2, 0.5
    spec_j = jbase.MoESpec(num_experts=E, top_k=k, capacity_factor=cf)
    spec_t = tbase.MoESpec(num_experts=E, top_k=k, capacity_factor=cf)
    p = jax.tree.map(np.asarray, JMoE.moe_init(jax.random.PRNGKey(3), 8, 16, spec_j, "swiglu"))
    x = np.random.default_rng(11).standard_normal((2, 6, 8)).astype(np.float32)

    def jax_kept(xb):
        S = xb.shape[0] * xb.shape[1]

        def out_s(down, s):
            q = dict(p, down={"w": down})
            return JMoE.moe_apply(q, jnp.asarray(xb), spec_j, "swiglu")[0].reshape(S, -1)[s].sum()

        g = jax.jit(jax.vmap(jax.grad(out_s), in_axes=(None, 0)))(jnp.asarray(p["down"]["w"]), jnp.arange(S))
        return np.abs(np.asarray(g)).reshape(S, E, -1).max(-1) > 0

    def port_kept(xb):
        S = xb.shape[0] * xb.shape[1]
        rows = []
        for s in range(S):
            down = torch.tensor(p["down"]["w"], requires_grad=True)
            q = {kk: ({"w": down} if kk == "down" else {k2: torch.tensor(v) for k2, v in vv.items()})
                 for kk, vv in p.items()}
            TMoE.moe_apply(q, torch.from_numpy(xb), spec_t, "swiglu")[0].reshape(S, -1)[s].sum().backward()
            rows.append(down.grad.abs().reshape(E, -1).amax(-1) > 0)
        return torch.stack(rows).numpy()

    kj, kt = jax_kept(x), port_kept(x)
    np.testing.assert_array_equal(kt, kj)
    assert kj.sum() < x.shape[0] * x.shape[1] * k  # the capacity drops assignments
    # the first row alone has a smaller capacity: what it keeps changes with the batch, in both packages
    kj1, kt1 = jax_kept(x[:1]), port_kept(x[:1])
    np.testing.assert_array_equal(kt1, kj1)
    assert not np.array_equal(kj1, kj[:6])
