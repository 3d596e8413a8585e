"""The LM slice as a whole, port against JAX, for the two archs with an SSM
(Mamba2-780m and Jamba) at ``smoke_config``, with the port's prefill conv
on "direct" and on "engine" (on CPU tensors the 1D engine's plain
version), against JAX's "direct": the checks of test_torch_lm_archs.py.

Tolerances: forward atol 1e-5 / rtol 1e-4, gradients 1e-4 of the largest
magnitude plus 1e-5 (ROADMAP §3).
"""
import pytest

import repro.configs as JC
from _lm_arch_cases import check_prefill_decode, check_train, make_case
import repro_torch.configs as TC
from repro_torch.models import ssm as TS

CASES = [(a, conv) for a in sorted(a for a, c in JC.LMS.items() if c.ssm is not None) for conv in ("direct", "engine")]


@pytest.fixture(scope="module", params=CASES, ids=[f"{a}-{c}" for a, c in CASES])
def case(request):
    yield make_case(JC, TC, *request.param)
    TS.set_conv_impl("direct")


def test_train_loss_and_gradients(case):
    check_train(case)


def test_prefill_then_decode(case):
    check_prefill_decode(case)


def test_decode_on_a_bf16_cache_matches_the_reference():
    """``decode_step`` writes into the cache it is given; on ``init_cache``'s
    default bf16 cache the conv states turn fp32, as the reference's new
    tree does, and the logits and every leaf match JAX's."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from _lm_pair import FWD, close_tree, jit, lm_params
    from repro.models import lm as JLM
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import lm as TLM

    cfg_j, cfg_t = JC.smoke_config("jamba-v0.1-52b"), TC.smoke_config("jamba-v0.1-52b")
    params = lm_params(cfg_j)
    tok = np.random.default_rng(3).integers(0, cfg_j.vocab, (2, 1)).astype(np.int32)
    jl, jc = jit(lambda p, c, t: JLM.decode_step(p, cfg_j, c, t, jnp.int32(0)))(params, JLM.init_cache(cfg_j, 2, 8),
                                                                              tok)
    cache = TLM.init_cache(cfg_t, 2, 8, device="cpu")
    with torch.no_grad():
        tl, tc = TLM.decode_step(lm_params_from_numpy(params, cfg_t, device="cpu"), cfg_t, cache,
                                 torch.from_numpy(tok.astype(np.int64)), 0)
    assert tc is cache
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)
    close_tree({k: type(c)(*(t.float() for t in c)) for k, c in tc.items()},
               jax.tree.map(lambda x: x.astype(jnp.float32), jc), "bf16 cache")
    got = [str(t.dtype).split(".")[-1] for c in tc.values() for t in c]
    assert got == [str(x.dtype) for x in jax.tree.leaves(jc)]
    assert "bfloat16" in got and got.count("float32") > got.count("int32")  # bf16 K / V rows, fp32 conv states
