"""The LM slice's arch checks, shared by test_torch_lm_archs.py (the
attention archs) and test_torch_lm_archs_ssm.py (the SSM archs, with both
prefill convs): ``case`` is (JAX's config, the port's, a numpy param tree,
a numpy batch).  JAX's results are computed once per arch and reused by
every conv variant of it (the reference's conv is "direct" throughout)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _lm_pair import FWD, close_grads, close_tree, grads, jit, leaf_params, lm_params
from repro.models import lm as JLM
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import lm as TLM
from repro_torch.models import ssm as TS

B, T = 2, 16


def _batch(cfg, rng):
    if cfg.frontend == "stub_embeds":
        b = {"embeds": (0.02 * rng.standard_normal((B, T, cfg.d_model))).astype(np.float32)}
        b["positions"] = (np.broadcast_to(np.arange(T)[None, :, None], (B, T, 3)) if cfg.mrope_sections
                          else np.broadcast_to(np.arange(T)[None, :], (B, T))).astype(np.int32)
    else:
        b = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    b["labels"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in b.items()}


def _cut(b, t):
    return {k: v[:, :t] for k, v in b.items() if k != "labels"}


_JAX: dict = {}


def _jax_once(cfg, what, run):
    key = (cfg.arch_id, what)
    if key not in _JAX:
        _JAX[key] = run()
    return _JAX[key]


def _copy(cache):
    """A cache's copy: decode_step writes into the cache it is given."""
    return {k: type(c)(*(leaf.clone() for leaf in c)) for k, c in cache.items()}


def make_case(jcfgs, tcfgs, arch, conv):
    """The case of ``arch`` with the port's prefill conv on ``conv``; sets
    the conv (the caller's fixture resets it)."""
    cfg_j = jcfgs.smoke_config(arch)
    TS.set_conv_impl(conv)
    return cfg_j, tcfgs.smoke_config(arch), lm_params(cfg_j), _batch(cfg_j, np.random.default_rng(0))


def check_train(case):
    cfg_j, cfg_t, params, batch = case
    loss, jg = _jax_once(cfg_j, "train", lambda: jit(jax.value_and_grad(
        lambda p: JLM.train_loss(p, cfg_j, jax.tree.map(jnp.asarray, batch), q_chunk=8, loss_chunk=8)))(params))
    tp = leaf_params(lm_params_from_numpy(params, cfg_t, device="cpu"))
    tl = TLM.train_loss(tp, cfg_t, _torch_batch(batch), q_chunk=8, loss_chunk=8)
    np.testing.assert_allclose(tl.item(), float(loss), **FWD)
    tl.backward()
    close_grads(grads(tp), jg)


def check_prefill_decode(case):
    """Prefill T - 1 tokens (logits and cache), then decode token T - 1
    (logits and cache)."""
    cfg_j, cfg_t, params, batch = case
    jpre = jit(lambda p, b: JLM.prefill(p, cfg_j, b, q_chunk=8, max_len=T + 1))
    jdec = jit(lambda p, c, tok, n: JLM.decode_step(p, cfg_j, c, tok, n))
    jl, jc = _jax_once(cfg_j, "prefill", lambda: jpre(params, _cut(batch, T - 1)))
    tp = lm_params_from_numpy(params, cfg_t, device="cpu")
    with torch.no_grad():
        tl, tc = TLM.prefill(tp, cfg_t, _torch_batch(_cut(batch, T - 1)), q_chunk=8, max_len=T + 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)
    close_tree(tc, jc, "prefill cache")
    key = "embeds" if cfg_j.frontend == "stub_embeds" else "tokens"
    tok = batch[key][:, T - 1 : T]
    jl2, jc2 = _jax_once(cfg_j, "decode", lambda: jdec(params, jc, tok, jnp.int32(T - 1)))
    with torch.no_grad():
        tl2, tc2 = TLM.decode_step(tp, cfg_t, _copy(tc), _torch_batch({key: tok})[key], T - 1)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **FWD)
    close_tree(tc2, jc2, "decode cache")
    # per-row lengths: row b decodes at T - 1 - b, as JAX decodes that row alone
    lens = np.array([T - 1 - b for b in range(B)])
    with torch.no_grad():
        tl3, tc3 = TLM.decode_step(tp, cfg_t, tc, _torch_batch({key: tok})[key], torch.from_numpy(lens))
    for b in range(B):
        row = jax.tree.map(lambda x: x[:, b : b + 1], jc)
        jl3, jc3 = _jax_once(cfg_j, f"row{b}", lambda: jdec(params, row, tok[b : b + 1], jnp.int32(lens[b])))
        np.testing.assert_allclose(tl3[b : b + 1].numpy(), np.asarray(jl3), **FWD)
        close_tree(jax.tree.map(lambda x: x[:, b : b + 1], tc3, is_leaf=lambda x: isinstance(x, torch.Tensor)),
                    jc3, f"row {b} cache")


