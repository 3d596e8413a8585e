"""Port parity of the LM stack's modules, one at a time: configs and the
registry, norms and embeddings, the three MLPs, RoPE / M-RoPE, chunked and
decode attention, and MoE (with and without drops) with its aux loss.  The
same numpy inputs and JAX's own parameters go through both packages (the
SSM's modules: test_torch_lm_ssm.py).

Tolerances: forward atol 1e-5 / rtol 1e-4; gradients 1e-4 of the largest
magnitude plus 1e-5 (ROADMAP §3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs import base as jbase
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models import mlp as JM
from repro.models import moe as JMoE
from _lm_pair import FWD, close_grads, dot, grads, jax_vjp, jit, leaf_params, shapes, to_np, to_t
import repro_torch.configs as TC
from repro_torch.configs import base as tbase
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models import mlp as TM
from repro_torch.models import moe as TMoE

# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", sorted(JC.LMS))
def test_configs_and_smoke_configs_equal_the_reference(arch):
    assert dataclasses.asdict(TC.LMS[arch]) == dataclasses.asdict(JC.LMS[arch])
    assert dataclasses.asdict(TC.smoke_config(arch)) == dataclasses.asdict(JC.smoke_config(arch))
    assert TC.get_config(arch) is TC.LMS[arch]
    for cfg_t, cfg_j in ((TC.LMS[arch], JC.LMS[arch]), (TC.smoke_config(arch), JC.smoke_config(arch))):
        assert TLM.superblock_period(cfg_t) == JLM.superblock_period(cfg_j)
        assert [dataclasses.asdict(s) for s in TLM.slot_specs(cfg_t)] == \
            [dataclasses.asdict(s) for s in JLM.slot_specs(cfg_j)]
        assert (cfg_t.hd, cfg_t.layer_kinds(), cfg_t.attn_kinds()) == (cfg_j.hd, cfg_j.layer_kinds(),
                                                                      cfg_j.attn_kinds())
    for name in JC.SHAPES:
        assert tbase.shape_applicable(TC.LMS[arch], TC.SHAPES[name]) == \
            jbase.shape_applicable(JC.LMS[arch], JC.SHAPES[name])


def test_registry_equals_the_reference():
    assert TC.list_archs() == JC.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}
    for arch in JC.GANS:
        assert tbase.shape_applicable(TC.get_config(arch), TC.SHAPES["train_4k"]) == (True, "GAN archs use their "
                                                                                           "own image shapes")
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("nope")


@pytest.mark.parametrize("arch", sorted(JC.LMS))
def test_param_shapes_are_the_references(arch):
    """``lm_param_shapes`` (the converter's check) is JAX's ``lm_init``
    tree, at the full published size (drawn on nothing in either)."""
    cfg = JC.LMS[arch]
    want = jax.eval_shape(lambda k: JLM.lm_init(k, cfg, jnp.float32), jax.random.PRNGKey(0))
    assert TLM.lm_param_shapes(TC.LMS[arch]) == jax.tree.map(lambda s: tuple(s.shape), want)


# ------------------------------------------------------- norms, embeddings
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "embedding"])
def test_norms_and_embedding(kind):
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 5, 16)) + 1).astype(np.float32)
    if kind == "embedding":
        p = jax.tree.map(np.asarray, JL.embedding_init(jax.random.PRNGKey(0), 32, 16))
        ids = rng.integers(0, 32, (2, 5))
        np.testing.assert_array_equal(TL.embedding(to_t(p), torch.from_numpy(ids)).numpy(),
                                      np.asarray(JL.embedding(p, jnp.asarray(ids))))
        return
    p = {"scale": (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = (0.1 * rng.standard_normal(16)).astype(np.float32)
    jfn, tfn = getattr(JL, kind), getattr(TL, kind)
    np.testing.assert_allclose(tfn(to_t(p), torch.from_numpy(x)).numpy(), np.asarray(jfn(p, jnp.asarray(x))), **FWD)
    _, jg = jit(jax.value_and_grad(lambda pp, xx: jnp.sum(jfn(pp, xx) ** 3), argnums=(0, 1)))(p, jnp.asarray(x))
    tp, tx = leaf_params(to_t(p)), torch.from_numpy(x).requires_grad_(True)
    torch.sum(tfn(tp, tx) ** 3).backward()
    close_grads({"p": grads(tp), "x": tx.grad}, {"p": jg[0], "x": jg[1]})
    ti = TL.rmsnorm_init(16) if kind == "rmsnorm" else TL.layernorm_init(16)
    ji = JL.rmsnorm_init(16) if kind == "rmsnorm" else JL.layernorm_init(16)
    assert to_np(ti).keys() == ji.keys() and all(np.array_equal(to_np(ti)[k], ji[k]) for k in ji)


# --------------------------------------------------------------------- MLP
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlps(kind):
    p = jax.tree.map(np.asarray, JM.mlp_init(jax.random.PRNGKey(1), 16, 32, kind))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    if kind == "gelu":
        p["up"]["b"] = (0.1 * rng.standard_normal(32)).astype(np.float32)
    np.testing.assert_allclose(TM.mlp_apply(to_t(p), torch.from_numpy(x), kind).numpy(),
                               np.asarray(JM.mlp_apply(p, jnp.asarray(x), kind)), **FWD)
    jg = jit(jax.grad(lambda pp: jnp.sum(JM.mlp_apply(pp, jnp.asarray(x), kind) ** 2)))(p)
    tp = leaf_params(to_t(p))
    torch.sum(TM.mlp_apply(tp, torch.from_numpy(x), kind) ** 2).backward()
    close_grads(grads(tp), jg)
    assert shapes(TM.mlp_init(torch.Generator().manual_seed(0), 16, 32, kind)) == shapes(p)


# -------------------------------------------------------------------- RoPE
@pytest.mark.parametrize("mrope", [False, True])
def test_rope(mrope):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    if mrope:
        pos = rng.integers(0, 40, (2, 6, 3))
        kw = dict(mrope_sections=(4, 2, 2))
    else:
        pos = np.broadcast_to(np.arange(6)[None] * 7, (2, 6)).copy()
        kw = {}
    got = TA.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5, **kw).numpy()
    np.testing.assert_allclose(got, np.asarray(JA.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5, **kw)), **FWD)


# --------------------------------------------------------------- attention
def _qkv(seed, B, T, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, h, hd)).astype(np.float32) for h in (H, Hkv, Hkv)]


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("q_chunk", [4, 7, 16, 64])
def test_attention(window, q_chunk):
    """``test_lm_stack.py``'s (window, q_chunk) cases, forward and
    gradients."""
    q, k, v = _qkv(0, 2, 16, 4, 2, 8)
    kw = dict(causal=True, window=window, q_chunk=q_chunk)
    want, ct, jg = jax_vjp(lambda a, b, c: JA.attention(a, b, c, **kw), (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = TA.attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    dot(got, ct).backward()
    close_grads((tq.grad, tk.grad, tv.grad), jg)


@pytest.mark.parametrize("ring", [False, True])
def test_decode_attention(ring):
    q, k, v = _qkv(1, 2, 12, 4, 2, 8)
    q = q[:, -1:]
    if ring:  # a window-6 ring: slot p % 6 holds position p, one row not yet filled
        kvp = np.array([[6, 7, 8, 9, 10, 5] * 2, [-1, 1, 2, 3, 4, 5] * 2], dtype=np.int32)[:, :12]
        kvp[:, 6:] = -1
        cl, kw_j, kw_t = 11, dict(kv_positions=jnp.asarray(kvp)), dict(kv_positions=torch.from_numpy(kvp))
    else:
        cl, kw_j, kw_t = 9, {}, {}
    want = JA.decode_attention(*map(jnp.asarray, (q, k, v)), jnp.int32(cl), **kw_j)
    got = TA.decode_attention(*map(torch.from_numpy, (q, k, v)), cl, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    # one batched call with a length a row is the rows decoded one at a time
    lens = np.array([cl, cl - 3])
    rows = [np.asarray(JA.decode_attention(*(jnp.asarray(a[b : b + 1]) for a in (q, k, v)), jnp.int32(lens[b]),
                                           **({"kv_positions": jnp.asarray(kvp[b : b + 1])} if ring else {})))
            for b in range(2)]
    got = TA.decode_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(lens), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.concatenate(rows), **FWD)


# --------------------------------------------------------------------- MoE
def _moe_case(cf, kind="swiglu", E=4, k=2, S=(2, 6)):
    spec_j = jbase.MoESpec(num_experts=E, top_k=k, every=1, capacity_factor=cf)
    spec_t = tbase.MoESpec(num_experts=E, top_k=k, every=1, capacity_factor=cf)
    p = jax.tree.map(np.asarray, JMoE.moe_init(jax.random.PRNGKey(0), 8, 16, spec_j, kind))
    x = np.random.default_rng(6).standard_normal((*S, 8)).astype(np.float32)
    return spec_j, spec_t, p, x


@pytest.mark.parametrize("cf,kind", [(4.0, "swiglu"), (0.5, "swiglu"), (0.75, "geglu"), (1.25, "gelu")])
def test_moe_apply_and_aux(cf, kind):
    """No drops (capacity 4.0) and capacities that drop (0.5: C = 3 of 24
    assignments over 4 experts), forward, aux loss and gradients."""
    spec_j, spec_t, p, x = _moe_case(cf, kind)
    (jy, jaux), ct, jg = jax_vjp(lambda pp, xx: JMoE.moe_apply(pp, xx, spec_j, kind), (p, x))
    tp, tx = leaf_params(to_t(p)), torch.from_numpy(x).requires_grad_(True)
    ty, taux = TMoE.moe_apply(tp, tx, spec_t, kind)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD)
    np.testing.assert_allclose(taux.item(), float(jaux), **FWD)
    dot((ty, taux), ct).backward()
    close_grads({"p": grads(tp), "x": tx.grad}, {"p": jg[0], "x": jg[1]})
    if cf == 0.5:  # the case drops: some token gets less than its two experts' worth
        _, spec_nd, _, _ = _moe_case(4.0, kind)
        full, _ = TMoE.moe_apply(to_t(p), torch.from_numpy(x), spec_nd, kind)
        assert not torch.allclose(full, ty.detach(), atol=1e-3)


def test_top_k_breaks_ties_to_the_lower_index():
    x = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]], np.float32)
    v, i = TMoE.top_k(torch.from_numpy(x), 2)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))




# ------------------------------------------------------------ data, convert
def test_lm_batch_and_embed_batch():
    """The reference's formulas on torch's stream: a pure function of (seed,
    step), labels the tokens shifted by one, ids in [0, vocab) with a
    Zipf-like marginal (the smallest ids the most frequent)."""
    from repro_torch import data as TD

    b = TD.lm_batch(3, 7, 4, 64, 50, device="cpu")
    assert b["tokens"].shape == b["labels"].shape == (4, 64) and b["tokens"].dtype == torch.int64
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert torch.equal(TD.lm_batch(3, 7, 4, 64, 50, device="cpu")["tokens"], b["tokens"])
    assert not torch.equal(TD.lm_batch(3, 8, 4, 64, 50, device="cpu")["tokens"], b["tokens"])
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) <= 49
    counts = torch.bincount(TD.lm_batch(0, 0, 64, 256, 1000, device="cpu")["tokens"].flatten(), minlength=1000)
    assert counts[0] > counts[1] > counts[5] > counts[50]
    e = TD.embed_batch(1, 2, 2, 5, 8, device="cpu")
    assert e.shape == (2, 5, 8) and torch.equal(e, TD.embed_batch(1, 2, 2, 5, 8, device="cpu"))
    assert 0.01 < float(e.std()) < 0.04


def test_lm_params_from_numpy_checks_keys_and_shapes():
    from _lm_pair import lm_params
    from repro_torch.convert import lm_params_from_numpy

    cfg_j, cfg_t = JC.smoke_config("jamba-v0.1-52b"), TC.smoke_config("jamba-v0.1-52b")
    tree = lm_params(cfg_j)
    got = lm_params_from_numpy(tree, cfg_t, device="cpu")
    np.testing.assert_array_equal(got["blocks"]["slot4"]["attn"]["wq"]["w"].numpy(),
                                  tree["blocks"]["slot4"]["attn"]["wq"]["w"])
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["slot0"]["mamba"]["in_x"]["w"] = bad["blocks"]["slot0"]["mamba"]["in_x"]["w"][:, :-1]
    with pytest.raises(ValueError, match="in_x/w"):
        lm_params_from_numpy(bad, cfg_t, device="cpu")
    del tree["head"]
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(tree, cfg_t, device="cpu")


def test_attention_bf16_qk():
    """``bf16_qk``: QK^T on the operands in their own dtype (fp32 here, as
    the reference's scaled in fp32) and bf16 ones rounded, fp32 softmax."""
    q, k, v = _qkv(5, 2, 16, 4, 2, 8)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jq, jk, jv = (jnp.asarray(a).astype(jdtype) for a in (q, k, v))
        want = JA.attention(jq, jk, jv, window=5, q_chunk=4, bf16_qk=True)
        tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
        got = TA.attention(tq, tk, tv, window=5, q_chunk=4, bf16_qk=True)
        tol = FWD if dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)  # bf16 outputs: 8 mantissa bits
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)
