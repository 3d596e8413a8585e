"""The LM stack on a mesh, on the CPU (gloo ranks from ``_torch_dist``, each
world spawned once for the module): ``launch.steps.build_lm_step`` against
JAX's single-device functions on the same numpy parameters and batches.

* The train step (``train_loss(mesh=)``'s share and its gradient, the
  gradients summed over the batch axes, the clip at the global norm,
  AdamW at lr 3e-4 on the blocks) for llama3-8b, mixtral-8x22b (capacity
  factor 0.5: assignments drop, and the count is asserted > 0) and
  jamba-v0.1-52b at ``smoke_config``, batch 4 of 16 tokens, on worlds (2, 1)
  and (2, 2) ("data", "model"): 3 steps, each held from one shared state
  (the port's state before it, run through JAX's ``value_and_grad(
  train_loss)`` and ``adamw_update(lr=3e-4, max_grad_norm=1.0)``): loss 1e-3
  relative, the global gradient norm 1e-4 relative, parameters 6·lr.
* A batch of 3 on (2, 1), which does not divide: every rank takes it whole,
  the fallback is in the log, and the steps hold as above.
* The prefill (``build_lm_step`` prefill): each rank's logits (atol 1e-5 /
  rtol 1e-4) and cache block against the rows and block of JAX's
  ``prefill``; a cache leaf within 1e-4 of its largest magnitude plus 1e-5
  (a rank runs its rows in smaller products than the whole batch's, and
  jamba's SSD carries their rounding into the attention layer's K / V).
* The MoE's global capacity: ``moe_apply(mesh=)`` on each rank's rows is
  JAX's ``moe_apply`` on the whole batch (its rows, and the aux loss as the
  sum of the shares), and the per-rank capacity, which is what the
  expert-parallel form computes, is not (the negative control)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist as TDist
import repro.configs as JC
import repro_torch.configs as TC
from _lm_pair import FWD, StandIn, jit, lm_params, np_block
from repro.models import lm as JLM
from repro.models import moe as JMoE
from repro.optim import OptState as JOptState
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch.parallel import sharding as TSH

LR = 3e-4
B, T = 4, 16
DROP_CF = 0.5  # mixtral's capacity factor: assignments drop
ARCHS = {"llama3-8b": None, "mixtral-8x22b": DROP_CF, "jamba-v0.1-52b": None}  # arch -> capacity factor
WORLDS = {"2x1": ((2, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model"))}


def _jcfg(arch, cf=None):
    cfg = JC.smoke_config(arch)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def _batch(cfg, rng, b=B, t=T, labels=True):
    out = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    return out


def _jax_step(cfg):
    def step(params, opt, batch):
        loss, g = jax.value_and_grad(lambda p: JLM.train_loss(p, cfg, batch, q_chunk=cfg.q_chunk,
                                                              loss_chunk=cfg.loss_chunk))(params)
        p2, o2, m = jadamw_update(params, g, opt, lr=LR, max_grad_norm=1.0)
        return p2, loss, m["grad_norm"]

    return jit(step)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh")
    rng = np.random.default_rng(0)
    cases = {}
    for arch, cf in ARCHS.items():
        cfg = _jcfg(arch, cf)
        cases[arch] = dict(cfg=cfg, params=lm_params(cfg), batches=[_batch(cfg, rng) for _ in range(3)],
                           prompt=_batch(cfg, rng, labels=False))
    llama = cases["llama3-8b"]
    odd = [_batch(llama["cfg"], rng, b=3) for _ in range(3)]
    train = [(a, a, ARCHS[a], B, c["params"], c["batches"]) for a, c in cases.items()]
    prefill = [(a, a, ARCHS[a], c["params"], c["prompt"]) for a, c in cases.items()]
    mix = _jcfg("mixtral-8x22b", DROP_CF)
    moe_np = jax.tree.map(np.asarray, cases["mixtral-8x22b"]["params"]["blocks"]["slot0"]["moe"])
    moe_np = jax.tree.map(lambda a: a[0], moe_np)
    x_np = rng.standard_normal((B, T, mix.d_model)).astype(np.float32)
    handles = {w: TDist.spawn_ranks(TDist.lm_mesh_runs, int(np.prod(s)), tmp, s, ax,
                                    train + ([("replicated", "llama3-8b", None, 3, llama["params"], odd)]
                                             if w == "2x1" else []),
                                    prefill, ("mixtral-8x22b", DROP_CF, moe_np, x_np) if w == "2x1" else None)
               for w, (s, ax) in WORLDS.items()}
    # JAX while the ranks run: each arch's step from the shared init (and its compile), the prefill
    steps = {a: _jax_step(c["cfg"]) for a, c in cases.items()}
    first = {a: steps[a](c["params"], jadamw_init(c["params"]), c["batches"][0]) for a, c in cases.items()}
    first["replicated"] = steps["llama3-8b"](llama["params"], jadamw_init(llama["params"]), odd[0])
    pre = {a: jit(lambda p, b, cfg=c["cfg"]: JLM.prefill(p, cfg, b, q_chunk=cfg.q_chunk, max_len=T + 1))(
        c["params"], c["prompt"]) for a, c in cases.items()}
    moe = JMoE.moe_apply(jax.tree.map(jnp.asarray, moe_np), jnp.asarray(x_np), mix.moe, mix.mlp)
    port = {w: TDist.collect(h) for w, h in handles.items()}
    cases["replicated"] = dict(cfg=llama["cfg"], params=llama["params"], batches=odd)
    return dict(cases=cases, steps=steps, first=first, pre=pre, moe=moe, port=port)


def _held_steps(runs, world, name, arch):
    """Each port step against JAX's from the same state: loss, grad norm,
    params; returns the steps' dropped assignments (rank 0)."""
    c = runs["cases"][name]
    got = runs["port"][world][0]["train"][name]["steps"]
    state, drops = c["params"], []
    for s, (b, r) in enumerate(zip(c["batches"], got)):
        opt = jadamw_init(c["params"]) if s == 0 else JOptState(
            jnp.int32(got[s - 1]["opt_step"]), got[s - 1]["m"], got[s - 1]["v"])
        want_p, want_loss, want_gn = runs["first"][name] if s == 0 else runs["steps"][arch](state, opt, b)
        assert abs(r["loss"] - float(want_loss)) <= 1e-3 * abs(float(want_loss)), (s, r["loss"], float(want_loss))
        assert abs(r["grad_norm"] - float(want_gn)) <= 1e-4 * abs(float(want_gn)), (s, r["grad_norm"], float(want_gn))
        for kp, w in jax.tree_util.tree_leaves_with_path(want_p):
            g = r["params"]
            for k in kp:
                g = g[k.key]
            np.testing.assert_allclose(g, np.asarray(w), atol=6 * LR, rtol=0, err_msg=f"step {s} {kp}")
        state = r["params"]
        drops.append(r["drops"])
    for other in runs["port"][world][1:]:  # every rank ends on the same loss
        assert [s["loss"] for s in other["train"][name]["steps"]] == [s["loss"] for s in got]
    return drops


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_mesh_train_step_matches_the_single_device_reference(runs, world, arch):
    drops = _held_steps(runs, world, arch, arch)
    if ARCHS[arch] is not None:  # the MoE at a capacity where assignments drop: the drop case is exercised
        total = sum(r["train"][arch]["steps"][0]["drops"] for r in runs["port"][world])
        assert total > 0 and drops[0] > 0
    assert all(r["train"][arch]["steps"][0]["rows"] == B // 2 for r in runs["port"][world])


def test_a_batch_that_does_not_divide_replicates(runs):
    _held_steps(runs, "2x1", "replicated", "llama3-8b")
    for r in runs["port"]["2x1"]:
        res = r["train"]["replicated"]
        assert res["steps"][0]["rows"] == 3
        assert any(line.startswith("batch: 3 %") and line.endswith("-> replicated") for line in res["fallbacks"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_mesh_prefill_gives_each_rank_its_rows_and_cache_block(runs, world, arch):
    shape, axes = WORLDS[world]
    mesh = StandIn(shape, axes)
    cfg_t = TC.smoke_config(arch)
    want_logits, want_cache = runs["pre"][arch]
    specs = TSH.cache_specs(cfg_t, TC.ShapeConfig("prefill_test", T, B, "prefill"), mesh)
    for r in runs["port"][world]:
        coords = r["prefill"]["coords"]
        got = r["prefill"][arch]
        rows = np_block(np.asarray(want_logits), TSH.P(("data",), None), coords, mesh.shape)
        np.testing.assert_allclose(got["logits"], rows, **FWD)
        for slot, c in want_cache.items():
            kind, fields = got["cache"][slot]
            assert kind == type(c).__name__
            for f, leaf in zip(c._fields, c):
                want = np_block(np.asarray(leaf), getattr(specs[slot], f), coords, mesh.shape)
                np.testing.assert_allclose(fields[f], want, atol=1e-4 * np.abs(want).max() + 1e-5, rtol=0,
                                           err_msg=f"{world} {arch} {slot}.{f}")


def test_global_capacity_moe_is_the_reference_and_per_rank_capacity_is_not(runs):
    want_out, want_aux = (np.asarray(t) for t in runs["moe"])
    ranks = [r["drop"] for r in runs["port"]["2x1"]]
    assert sum(r["drops"] for r in ranks) > 0
    got = np.concatenate([r["out"] for r in ranks])
    np.testing.assert_allclose(got, want_out, **FWD)
    np.testing.assert_allclose(sum(r["aux"] for r in ranks), float(want_aux), rtol=1e-5)
    plain = np.concatenate([r["plain"] for r in ranks])
    assert np.abs(plain - want_out).max() > 1e-2  # per-rank capacity drops other assignments
