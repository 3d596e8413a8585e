"""Tensor parallelism in the LM mesh steps, on the CPU (gloo ranks from
``_torch_dist``, each world spawned once for the module): with a "model"
extent of 2 every rank keeps its "model" block of each split leaf and
computes on it (``parallel/tp.py``), and ``launch.steps.build_lm_step`` is
still the reference's function, held against JAX's single-device functions
on the same numpy parameters and batches.

* Worlds (1, 2) and (2, 2) ("data", "model"); llama3-8b, mixtral-8x22b
  (capacity factor 0.5: assignments drop) and jamba-v0.1-52b at
  ``smoke_config``, and llama3-8b with one kv head (``kv1``: the kv heads do
  not divide over 2 ranks, so wk / wv replicate and each rank reads the kv
  head its query heads map to; their gradient is partial over "model").
* Train: 3 steps, each held from one shared state against JAX's
  ``value_and_grad(train_loss)`` + ``adamw_update(lr=3e-4,
  max_grad_norm=1.0)``: loss 1e-3 relative, global gradient norm 1e-4
  relative, parameters 6·lr.  On (2, 2) also the expert-parallel step
  (``ep``: mixtral's smoke config with E = 2 experts, one a "data" shard,
  top-1 at capacity factor 1.0, so assignments drop): the expert's
  gradient summed over the batch axes it does not live on, the clip's
  norm counted once a block.  Its capacity and aux loss are each source
  shard's own, so its single-device function is the mean over the "data"
  shards of JAX's ``train_loss`` on each shard's rows.
* Prefill of T - 1 = 15 tokens (a cache of T positions): each rank's
  logits against the reference's ``P(batch, "model")`` block (atol 1e-5 /
  rtol 1e-4), and its cache block (1e-4 of the leaf's largest magnitude
  plus 1e-5).
* Decode of token T - 1 from JAX's prefill cache: ``build_lm_step``'s
  decode cell (the batch split over "data"), and on (2, 2) the
  sequence-sharded decode (a batch of 3, replicated; the cache's sequence
  over "data"): logits block and cache block.
* Under ``launch/op_costs.py``'s recorder: no all-gather over "model" in a
  train step; on (1, 2) a rank's matmul FLOPs are half the single-device
  step's, plus half of the products that run whole on every rank (the
  replicated leaves' products, counted from the specs).
* ``moe_apply_ep`` on (2, 2) with E = 2 experts, top-1 (one a "data" shard,
  each expert's ``ff`` split over "model"; assignments drop) against JAX's ``moe_apply_ep`` on a
  (2, 2) mesh of 4 host devices in a subprocess: output, aux loss, and the
  gradients of sum(out * ct) + aux in x and every weight.
* ``parallel.tp.row_parallel`` of a bf16 product: rounded once, after the
  fp32 sum over "model".
* ``parallel.tp.local_kv`` where the local query heads straddle kv groups
  (6 query heads over 3 kv heads on 2 ranks), against whole-head attention.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as TDist
import repro.configs as JC
import repro_torch.configs as TC
from _lm_pair import FWD, StandIn, jit, lm_params, np_block
from repro.models import lm as JLM
from repro.optim import OptState as JOptState
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch.models import lm as TLM
from repro_torch.models.attention import attention
from repro_torch.parallel import sharding as TSH
from repro_torch.parallel import tp as TPx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 3e-4
B, T = 4, 16
DROP_CF = 0.5
# name -> (arch, the config's replaced fields, capacity factor)
CASES = {"llama3-8b": ("llama3-8b", {}, None), "mixtral-8x22b": ("mixtral-8x22b", {}, DROP_CF),
         "jamba-v0.1-52b": ("jamba-v0.1-52b", {}, None), "kv1": ("llama3-8b", {"n_kv_heads": 1}, None)}
WORLDS = {"1x2": ((1, 2), ("data", "model")), "2x2": ((2, 2), ("data", "model"))}
SEQ_B = 3  # the sequence-sharded decode's batch (replicated: it does not divide over "data")
EP_SHARDS = 2  # the expert-parallel case's "data" extent, on (2, 2): one expert a shard
SEQ_CASES = ("llama3-8b", "kv1")


def _jcfg(name):
    arch, over, cf = CASES[name]
    cfg = dataclasses.replace(JC.smoke_config(arch), **over)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def _tcfg(name):
    return TDist._lm_cfg(_arg(name))


def _arg(name):
    """The workers' config: (arch, the port config's replaced fields)."""
    arch, over, cf = CASES[name]
    if cf is not None:
        over = dict(over, moe=dataclasses.replace(TC.smoke_config(arch).moe, capacity_factor=cf))
    return (arch, over) if over else arch


def _batch(cfg, rng, b=B, t=T, labels=True):
    out = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    return out


def _state(cache):
    return {k: (type(c).__name__, {f: np.asarray(v) for f, v in zip(c._fields, c)}) for k, c in cache.items()}


def _ep_moe(moe):
    return dataclasses.replace(moe, num_experts=EP_SHARDS, top_k=1, capacity_factor=1.0)


def _jax_step(cfg, shards=1):
    """JAX's train step; with ``shards`` the loss is the mean of
    ``train_loss`` over that many equal slices of the batch's rows (the
    expert-parallel MoE's function: each source shard's capacity and aux
    loss its own)."""
    def loss(p, batch):
        rows = next(iter(batch.values())).shape[0] // shards
        return sum(JLM.train_loss(p, cfg, {k: v[i * rows : (i + 1) * rows] for k, v in batch.items()},
                                  q_chunk=cfg.q_chunk, loss_chunk=cfg.loss_chunk) for i in range(shards)) / shards

    def step(params, opt, batch):
        value, g = jax.value_and_grad(loss)(params, batch)
        p2, _, m = jadamw_update(params, g, opt, lr=LR, max_grad_norm=1.0)
        return p2, value, m["grad_norm"]

    return jit(step)


def _on_threads(fn, names) -> dict:
    """``fn(name)`` for every name at once, one thread each (JAX's compiles
    overlap)."""
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(fn, names)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_tp")
    ep_w, ep_x, ep_ct, ep_args = _ep_inputs()
    with _jax_ep(tmp, ep_w, ep_x, ep_ct) as jax_ep:  # leaving the block waits for the subprocess
        return _tp_runs(tmp, ep_args, jax_ep)


def _tp_runs(tmp, ep_args, jax_ep):
    """Both worlds' ranks (the (2, 2) one also runs ``ep_args``'s MoE) and,
    while they run, JAX's steps, prefills and decodes, then JAX's EP."""
    rng = np.random.default_rng(0)
    cases = {}
    for name in CASES:
        cfg = _jcfg(name)
        cases[name] = dict(cfg=cfg, params=lm_params(cfg), batches=[_batch(cfg, rng) for _ in range(3)],
                           tokens=_batch(cfg, rng, labels=False)["tokens"],
                           seq_tokens=_batch(cfg, rng, b=SEQ_B, labels=False)["tokens"])

    def prefill(name):  # the prompt's first T - 1 tokens into T positions: the prefill cell's, and the decode's cache
        c = cases[name]
        pre = jit(lambda p, b, cfg=c["cfg"]: JLM.prefill(p, cfg, b, q_chunk=cfg.q_chunk, max_len=T))
        return {key: pre(c["params"], {"tokens": c[key][:, : T - 1]})
                for key in ("tokens", "seq_tokens") if key == "tokens" or name in SEQ_CASES}

    pre = _on_threads(prefill, list(CASES))
    jcfg = JC.smoke_config("mixtral-8x22b")
    jcfg = dataclasses.replace(jcfg, moe=_ep_moe(jcfg.moe))
    ep = dict(cfg=jcfg, params=lm_params(jcfg, seed=1), batches=[_batch(jcfg, rng) for _ in range(3)])
    ep_arg = ("mixtral-8x22b", {"moe_ep": True, "moe": _ep_moe(TC.smoke_config("mixtral-8x22b").moe)})
    train = [(n, _arg(n), None, B, c["params"], c["batches"]) for n, c in cases.items()]
    prompts = [(n, _arg(n), None, c["params"], {"tokens": c["tokens"][:, : T - 1]}) for n, c in cases.items()]
    costs = [(n, _arg(n), None, c["params"], c["batches"][0]) for n, c in cases.items()]
    decode = {w: [(f"{n}/{kind}", _arg(n), c["params"], _state(pre[n][key][1]), c[key][:, T - 1 :], T - 1,
                   kind == "seq")
                  for n, c in cases.items() for kind, key in (("decode", "tokens"), ("seq", "seq_tokens"))
                  if kind == "decode" or (w == "2x2" and n in SEQ_CASES)] for w in WORLDS}
    train = {w: train + [("ep", ep_arg, None, B, ep["params"], ep["batches"])] if w == "2x2" else train
             for w in WORLDS}
    handles = {w: TDist.spawn_ranks(TDist.lm_tp_runs, int(np.prod(s)), tmp, s, ax, train[w], prompts, decode[w],
                                    costs, ep_args if w == "2x2" else None) for w, (s, ax) in WORLDS.items()}

    def reference(name):  # JAX while the ranks run: the first step (and the step's compile), the decode steps
        if name == "ep":
            step = _jax_step(ep["cfg"], EP_SHARDS)
            return step, step(ep["params"], jadamw_init(ep["params"]), ep["batches"][0]), {}
        c = cases[name]
        step = _jax_step(c["cfg"])
        dec = jit(lambda p, cache, tok, cl, cfg=c["cfg"]: JLM.decode_step(p, cfg, cache, tok, cl))
        out = {"decode": dec(c["params"], pre[name]["tokens"][1], c["tokens"][:, T - 1 :], jnp.int32(T - 1))}
        if name in SEQ_CASES:
            out["seq"] = dec(c["params"], pre[name]["seq_tokens"][1], c["seq_tokens"][:, T - 1 :], jnp.int32(T - 1))
        return step, step(c["params"], jadamw_init(c["params"]), c["batches"][0]), out

    ref = _on_threads(reference, [*CASES, "ep"])
    port = {w: TDist.collect(h) for w, h in handles.items()}
    _, err = jax_ep.communicate(timeout=300)
    assert jax_ep.returncode == 0, err[-3000:]
    return dict(cases=dict(cases, ep=ep), steps={n: r[0] for n, r in ref.items()}, first={n: r[1] for n, r in ref.items()},
                pre={n: p["tokens"] for n, p in pre.items()},
                dec={f"{n}/{k}": v for n, r in ref.items() for k, v in r[2].items()}, port=port,
                ep=dict(port=[r["ep"] for r in port["2x2"]], jax=dict(np.load(tmp / "out.npz"))))


def _check_train(runs, world, name, drops):
    """The world's train steps of case ``name`` against JAX's, each from the
    port's state before it; every rank on the same loss and norm; with
    ``drops`` some MoE assignments dropped."""
    c = runs["cases"][name]
    got = runs["port"][world][0]["train"][name]["steps"]
    state = c["params"]
    for s, (b, r) in enumerate(zip(c["batches"], got)):
        opt = jadamw_init(c["params"]) if s == 0 else JOptState(
            jnp.int32(got[s - 1]["opt_step"]), got[s - 1]["m"], got[s - 1]["v"])
        want_p, want_loss, want_gn = runs["first"][name] if s == 0 else runs["steps"][name](state, opt, b)
        assert abs(r["loss"] - float(want_loss)) <= 1e-3 * abs(float(want_loss)), (s, r["loss"], float(want_loss))
        assert abs(r["grad_norm"] - float(want_gn)) <= 1e-4 * abs(float(want_gn)), (s, r["grad_norm"], float(want_gn))
        for kp, w in jax.tree_util.tree_leaves_with_path(want_p):
            g = r["params"]
            for k in kp:
                g = g[k.key]
            np.testing.assert_allclose(g, np.asarray(w), atol=6 * LR, rtol=0, err_msg=f"{world} step {s} {kp}")
        state = r["params"]
    for other in runs["port"][world][1:]:  # every rank ends on the same loss and norm
        assert [(s["loss"], s["grad_norm"]) for s in other["train"][name]["steps"]] == \
            [(s["loss"], s["grad_norm"]) for s in got]
    if drops:  # the MoE at a capacity where assignments drop
        assert sum(r["train"][name]["steps"][0]["drops"] for r in runs["port"][world]) > 0


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_tp_train_steps_match_the_single_device_reference(runs, world, name):
    _check_train(runs, world, name, CASES[name][2] is not None)


def test_ep_train_steps_on_2x2_match_the_reference(runs):
    """The expert-parallel step with its experts' ``ff`` split over "model"
    (``build_lm_step``: each expert's gradient summed over the batch axes
    but "data", the router's over all of them; the clip's norm from every
    block once)."""
    _check_train(runs, "2x2", "ep", True)


def _cache_blocks(got, want_cache, specs, coords, mesh, what):
    for slot, c in want_cache.items():
        kind, fields = got[slot]
        assert kind == type(c).__name__
        for f, leaf in zip(c._fields, c):
            want = np_block(np.asarray(leaf), getattr(specs[slot], f), coords, mesh.shape)
            assert fields[f].shape == want.shape, (what, slot, f)
            np.testing.assert_allclose(fields[f], want, atol=1e-4 * np.abs(want).max() + 1e-5, rtol=0,
                                       err_msg=f"{what} {slot}.{f}")


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_tp_prefill_gives_each_rank_its_logits_and_cache_block(runs, world, name):
    mesh = StandIn(*WORLDS[world])
    want_logits, want_cache = runs["pre"][name]
    specs = TSH.cache_specs(_tcfg(name), TC.ShapeConfig("prefill_test", T - 1, B, "prefill"), mesh)
    for r in runs["port"][world]:
        got = r["prefill"][name]
        assert got["out_spec"] == ("data", "model")  # the vocabulary splits: each rank holds its slice
        want = np_block(np.asarray(want_logits), TSH.P(*got["out_spec"]), r["prefill"]["coords"], mesh.shape)
        assert got["logits_block"].shape == (B // mesh.shape["data"], _tcfg(name).vocab // 2)
        np.testing.assert_allclose(got["logits_block"], want, **FWD)
        _cache_blocks(got["cache"], want_cache, specs, r["prefill"]["coords"], mesh, f"{world} {name}")


@pytest.mark.parametrize("world,key", [(w, f"{n}/decode") for w in sorted(WORLDS) for n in sorted(CASES)]
                         + [("2x2", f"{n}/seq") for n in SEQ_CASES])
def test_tp_decode_step_matches_the_reference(runs, world, key):
    name, kind = key.split("/")
    mesh = StandIn(*WORLDS[world])
    seq = kind == "seq"
    want_logits, want_cache = runs["dec"][key]
    specs = TSH.cache_specs(_tcfg(name), TC.ShapeConfig("decode_test", T, SEQ_B if seq else B, "decode"), mesh,
                            seq_shard=seq)
    for r in runs["port"][world]:
        got = r["decode"][key]
        assert got["out_spec"][1] == "model"
        want = np_block(np.asarray(want_logits), TSH.P(*got["out_spec"]), r["decode"]["coords"], mesh.shape)
        np.testing.assert_allclose(got["logits_block"], want, **FWD)
        _cache_blocks(got["cache"], want_cache, specs, r["decode"]["coords"], mesh, f"{world} {key}")


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_no_all_gather_over_model_in_a_train_step(runs, world):
    for r in runs["port"][world]:
        c = r["costs"]
        for name in CASES:
            ops = c[name]["collectives"]
            assert ops and all(ranks is not None for _, ranks in ops)
            assert any(ranks == c["model_ranks"] for _, ranks in ops)  # the model group's sums are there
            gathers = [ranks for op, ranks in ops if "allgather" in op or "all_gather" in op]
            assert c["model_ranks"] not in gathers, (world, name)


def _replicated_products(cfg) -> float:
    """The matmul FLOPs of a train step at batch (B, T) that a rank of
    model extent 2 runs whole: the products of the leaves that stay whole
    on every rank (``lm_param_specs``: a kv projection whose heads do not
    divide, the Mamba mixer's ``in_B`` / ``in_C`` and the ``C·B`` einsum
    of its SSD, the MoE's router), each run forward, again under remat,
    and twice backward."""
    rows, D = B * T, cfg.d_model
    fwd = 0
    for sp in TLM.slot_specs(cfg):
        if sp.kind == "attn" and cfg.n_kv_heads % 2:
            fwd += 2 * 2 * rows * D * cfg.n_kv_heads * cfg.hd
        if sp.kind == "mamba":
            N, ck = cfg.ssm.d_state, min(cfg.ssm.chunk, T)
            fwd += 2 * 2 * rows * D * N + 2 * B * (T // ck) * ck * ck * N
        if sp.ffn == "moe":
            fwd += 2 * rows * D * cfg.moe.num_experts
    return fwd * (cfg.n_layers // TLM.superblock_period(cfg)) * (4 if cfg.remat else 3)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_halves_a_ranks_matmul_flops_on_1x2(runs, name):
    rep = _replicated_products(_tcfg(name))
    assert (rep > 0) == (name != "llama3-8b")
    single = runs["port"]["1x2"][0]["costs"][name]["single_matmul"]
    for r in runs["port"]["1x2"]:
        c = r["costs"][name]
        assert c["step_matmul"] == (single - rep) / 2 + rep, (c["step_matmul"], single, rep)


# ------------------------------------------------------------------ EP on (2, 2)
JAX_EP = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.configs import smoke_config
from repro.models import moe as M

src, dst = sys.argv[1], sys.argv[2]
cfg = smoke_config("mixtral-8x22b")
spec = dataclasses.replace(cfg.moe, num_experts=2, top_k=1, capacity_factor=1.0)
a = dict(np.load(src))
p = {k: {"w": jnp.asarray(a[k])} for k in ("router", "up", "gate", "down")}
mesh = make_mesh((2, 2), ("data", "model"))
fn = lambda p, x: M.moe_apply_ep(p, x, spec, cfg.mlp, mesh=mesh)
loss = lambda p, x: (lambda o: jnp.sum(o[0] * a["ct"]) + o[1])(fn(p, x))
out, aux = jax.jit(fn)(p, a["x"])
dp, dx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, a["x"])
np.savez(dst, out=np.asarray(out), aux=np.asarray(aux), dx=np.asarray(dx),
         **{"d_" + k: np.asarray(v["w"]) for k, v in dp.items()})
"""


def _ep_inputs():
    """E = 2 experts of mixtral's smoke MoE (swiglu), top-1 (top-2 of 2
    experts would route every token to both, and drop none) at capacity
    factor 1.0, 8 rows of 4 tokens: numpy weights, x and the cotangent."""
    rng = np.random.default_rng(3)
    D, F, E = 64, 128, 2
    w = {"router": rng.standard_normal((D, E)) / 8, "up": rng.standard_normal((E, D, F)) / 8,
         "gate": rng.standard_normal((E, D, F)) / 8, "down": rng.standard_normal((E, F, D)) / 11}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((8, 4, D)).astype(np.float32)
    ct = rng.standard_normal((8, 4, D)).astype(np.float32)
    moe = dataclasses.replace(TC.smoke_config("mixtral-8x22b").moe, num_experts=E, top_k=1, capacity_factor=1.0)
    return w, x, ct, (("mixtral-8x22b", {"moe": moe}), None, {k: {"w": v} for k, v in w.items()}, x, ct)


def _jax_ep(tmp, w, x, ct):
    """JAX's ``moe_apply_ep`` on a (2, 2) mesh of 4 host devices, started
    in a subprocess; ``.communicate()`` and ``out.npz`` give its result."""
    np.savez(tmp / "in.npz", x=x, ct=ct, **w)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_EP), str(tmp / "in.npz"), str(tmp / "out.npz")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


@pytest.fixture(scope="module")
def ep22(runs):
    """The (2, 2) world's ``moe_apply_ep`` ranks and JAX's (``runs``)."""
    return runs["ep"]


def _by_data(ranks, model=0):
    return [r for r in sorted(ranks, key=lambda r: r["coords"]["data"]) if r["coords"]["model"] == model]


def test_ep_on_2x2_output_and_aux_match_the_reference(ep22):
    for m in (0, 1):  # both model ranks of a data shard give its rows
        ranks = _by_data(ep22["port"], m)
        np.testing.assert_allclose(np.concatenate([r["out"] for r in ranks]), ep22["jax"]["out"], **FWD)
        np.testing.assert_allclose(sum(r["aux"] for r in ranks), float(ep22["jax"]["aux"]), **FWD)
    assert sum(r["drops"] for r in _by_data(ep22["port"])) > 0


@pytest.mark.parametrize("leaf", ("x", "router", "up", "gate", "down"))
def test_ep_on_2x2_gradients_match_the_reference(ep22, leaf):
    """The reference's ``psum`` over "model" runs under ``check_vma=False``:
    its transpose is a ``psum`` of the cotangents, and shard_map divides an
    unmentioned axis's output cotangent by its extent, so the two cancel
    and its gradient is the function's.  The port's "f" / "g" give the
    same."""
    want = ep22["jax"]["dx" if leaf == "x" else "d_" + leaf]
    if leaf == "x":
        got = np.concatenate([r["dx"] for r in _by_data(ep22["port"])])
        np.testing.assert_array_equal(got, np.concatenate([r["dx"] for r in _by_data(ep22["port"], 1)]))
    elif leaf == "router":  # whole on every rank: a data shard's gradient once
        got = sum(r["dp"][leaf]["w"] for r in _by_data(ep22["port"]))
    else:  # each rank's block of its expert's ff
        got = sum(r["dp"][leaf]["w"] for r in ep22["port"])
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max() + 1e-5, rtol=0)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_a_bf16_row_parallel_product_is_rounded_once_after_the_sum(runs, world):
    """Each rank's partial product of bf16 inputs stays in fp32 until the
    sum over "model", which is rounded to bf16 once (the reference's
    partitioned bf16 dot as XLA compiles it: an fp32 dot, an fp32
    all-reduce, one convert): the two ranks' fp32 products summed, then
    rounded, bit for bit; within half a bf16 ulp of the whole product."""
    for r in runs["port"][world]:
        got = r["row_parallel"]
        assert got["dtype"] == "torch.bfloat16"
        x, w = torch.from_numpy(got["x"]), torch.from_numpy(got["w"])
        k = x.shape[1] // 2
        want = (x[:, :k] @ w[:k] + x[:, k:] @ w[k:]).bfloat16().float().numpy()
        np.testing.assert_array_equal(got["out"], want)
        np.testing.assert_allclose(got["out"], (x @ w).numpy(), rtol=2.0**-8, atol=0)


# ------------------------------------------------------------------ kv heads
@pytest.mark.parametrize("heads", [(6, 3, 2), (4, 1, 2), (8, 2, 4), (8, 4, 2)])
def test_local_kv_gives_each_rank_the_kv_heads_its_query_heads_read(heads):
    """H query heads over Hkv kv heads on n ranks: each rank's n_q = H / n
    heads against ``local_kv``'s kv heads give its slice of the whole
    attention (the straddling case (6, 3, 2) reads one kv head a query
    head)."""
    H, Hkv, n = heads
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 12, h, 8), generator=g) for h in (H, Hkv, Hkv))
    whole = attention(q, k, v, causal=True, q_chunk=4)
    n_q = H // n
    for r in range(n):
        q0 = r * n_q
        got = attention(q[:, :, q0 : q0 + n_q], TPx.local_kv(k, q0, n_q, H // Hkv), TPx.local_kv(v, q0, n_q, H // Hkv),
                        causal=True, q_chunk=4)
        torch.testing.assert_close(got, whole[:, :, q0 : q0 + n_q], atol=1e-6, rtol=1e-5)


def test_local_specs_and_partial_gradients_follow_the_specs():
    """``lm_local_specs`` keeps exactly the "model" entries (and EP's expert
    dimension); ``lm_grad_partial`` marks the replicated leaves consumed on
    a rank's slice, and nothing at model extent 1."""
    mesh = StandIn((2, 2), ("data", "model"))
    cfg = _tcfg("kv1")
    specs = TSH.lm_param_specs(cfg, mesh)[0]
    local = TSH.lm_local_specs(cfg, mesh, specs)
    TSH.map_specs(lambda sp, kp: None if all(k == (s if s == "model" else None) for s, k in zip(sp, kp)) else
                  pytest.fail(f"{sp} -> {kp}"), specs, local)
    part = TSH.lm_grad_partial(cfg, mesh, specs)
    attn = part["blocks"]["slot0"]["attn"]
    assert attn["wk"]["w"] and attn["wv"]["w"] and not attn["wq"]["w"] and not attn["wo"]["w"]
    jam = TSH.lm_grad_partial(_tcfg("jamba-v0.1-52b"), mesh)
    mamba = [s["mamba"] for s in jam["blocks"].values() if "mamba" in s][0]
    assert mamba["in_B"]["w"] and mamba["conv_C"]["b"] and not mamba["in_x"]["w"] and not mamba["out_proj"]["w"]
    one = TSH.lm_grad_partial(cfg, StandIn((2, 1), ("data", "model")))
    assert not any(jax.tree_util.tree_leaves(one))
    ep = dataclasses.replace(_tcfg("mixtral-8x22b"), moe_ep=True, moe=dataclasses.replace(
        _tcfg("mixtral-8x22b").moe, num_experts=2))
    up = TSH.lm_local_specs(ep, mesh)["blocks"]["slot0"]["moe"]["up"]["w"]
    assert up == TSH.P(None, "data", None, "model")
