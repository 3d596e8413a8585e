"""The LM ``ServeEngine`` against the reference's on the same requests, for
llama3-8b and mamba2-780m at ``smoke_config`` (one numpy param tree for
both): more requests than slots, prompts shorter and longer than
``prompt_len``, so slots are refilled while others decode at their own
positions.

Every prefill's and decode step's logits are held at atol 2e-4 / rtol 2e-3
(``test_arch_smoke.py``'s prefill-versus-decode tolerance: the logits of a
served step pass through a whole prefill and the decode steps after it),
and the greedy tokens must be equal wherever the reference's top-2 margin
exceeds twice that atol.  Also the reference's own serve tests' checks on
the port: slot reuse, and the engine's output against a straight-line
prefill and decode.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from _lm_pair import lm_params
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
import repro_torch.configs as TC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import lm as TLM
from repro_torch.serve import Request, ServeEngine

TOL = dict(atol=2e-4, rtol=2e-3)
PROMPTS = [[5, 9, 1], [17, 3, 3, 8, 250, 1, 2, 40, 7, 11], [2] * 8, [99, 98], [7, 1, 7, 1, 7]]


def _recording(eng, port: bool):
    """Record every prefill's and decode's logits of an engine."""
    log = []
    pre, dec = eng._prefill_one, eng._decode

    def prefill_one(*a):
        out = pre(*a)
        log.append(("prefill", np.asarray(out[0].cpu() if port else out[0])))
        return out

    def decode(*a):
        out = dec(*a)
        log.append(("decode", np.asarray(out[0].cpu() if port else out[0])))
        return out

    eng._prefill_one, eng._decode = prefill_one, decode
    return log


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m"])
def test_serve_engine_matches_the_reference(arch):
    cfg_j, cfg_t = JC.smoke_config(arch), TC.smoke_config(arch)
    params = lm_params(cfg_j, seed=1)
    kw = dict(slots=2, max_len=32, prompt_len=8)
    jeng = JServeEngine(jax.tree.map(jax.numpy.asarray, params), cfg_j, **kw)
    teng = ServeEngine(lm_params_from_numpy(params, cfg_t, device="cpu"), cfg_t, **kw)
    jlog, tlog = _recording(jeng, False), _recording(teng, True)
    jdone = jeng.run([JRequest(rid=i, tokens=p, max_new=4 + i % 3) for i, p in enumerate(PROMPTS)])
    tdone = teng.run([Request(rid=i, tokens=p, max_new=4 + i % 3) for i, p in enumerate(PROMPTS)])
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [kind for kind, _ in tlog] == [kind for kind, _ in jlog]
    margins = []
    for (kind, t), (_, j) in zip(tlog, jlog):
        np.testing.assert_allclose(t, j, **TOL, err_msg=kind)
        top2 = np.sort(j, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
    decided = {r.rid: r.out for r in jdone}
    for r in tdone:
        assert len(r.out) == len(decided[r.rid]) and r.done
    # a token may differ only where the reference's top-2 margin is within twice the logit tolerance
    assert min(float(m.min()) for m in margins) > 2 * TOL["atol"], "a near-tie: compare token by token"
    assert [r.out for r in tdone] == [r.out for r in jdone]


def test_engine_reuses_slots_and_matches_straight_line_decode():
    """The reference's serve tests on the port: five requests through two
    slots all finish with in-vocab tokens, and a lone request's output is
    the straight-line prefill + decode's."""
    cfg = TC.smoke_config("llama3-8b")
    params = TLM.lm_init(cfg, device="cpu")
    eng = ServeEngine(params, cfg, slots=2, max_len=64, prompt_len=8)
    done = eng.run([Request(rid=i, tokens=list(range(1, 8)), max_new=4) for i in range(5)])
    assert len(done) == 5 and all(len(r.out) == 4 for r in done)
    assert all(0 <= t < cfg.vocab for r in done for t in r.out)

    eng = ServeEngine(params, cfg, slots=1, max_len=64, prompt_len=8)
    prompt = list(range(1, 8))
    got = eng.run([Request(rid=0, tokens=prompt, max_new=3)])[0].out
    with torch.no_grad():
        logits, cache = TLM.prefill(params, cfg, {"tokens": torch.tensor([(prompt + [0] * 8)[:8]])}, q_chunk=64,
                                    max_len=64)
        want = [int(torch.argmax(logits[0]))]
        cur, pos = want[0], 7
        for _ in range(2):
            lg, cache = TLM.decode_step(params, cfg, cache, torch.tensor([[cur]]), pos)
            cur = int(torch.argmax(lg[0]))
            want.append(cur)
            pos += 1
    assert got == want
