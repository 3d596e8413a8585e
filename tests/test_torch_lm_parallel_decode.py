"""The LM's decode on a mesh, on the CPU (gloo ranks from ``_torch_dist``,
every world spawned once for the module), against JAX's single-device
functions on the same numpy inputs.

* ``seq_sharded_decode_attention`` on world 4, each rank holding a quarter
  of a 32-position KV cache (GQA, 4 query heads over 2 kv heads), against
  JAX's ``decode_attention``: the valid keys from the slice's own positions
  below ``cache_len``, and from ``kv_positions`` (a ring's scattered
  positions, some empty), atol 1e-5 / rtol 1e-4.
* ``decode_step(seq_shard_axis="data")`` on worlds (2, 1) and (2, 2) for
  gemma3-12b (its local layers' rings whole on each rank) and
  jamba-v0.1-52b (SSM caches whole) at ``smoke_config``, batch 3
  (replicated), one token after a prefill of 15: the logits, and each
  rank's block of the new cache against the block of JAX's new cache under
  ``cache_specs(seq_shard=True)``; the new K/V row lands in rank 1's half of
  a 20-slot cache (gemma3) and in rank 0's half of a 32-slot one (jamba); on
  (2, 2) the kv heads and SSM channels also split over "model", gathered
  for the step and written back.
* ``build_lm_step``'s decode cell for mixtral-8x22b (batch 4 split over
  "data"): each rank's rows' logits and cache block; its MoE routes with
  the global batch's capacity (drops included), as JAX's decode does."""
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist as TDist
import repro.configs as JC
import repro_torch.configs as TC
from _lm_pair import FWD, StandIn, jit, lm_params, np_block
from repro.models import lm as JLM
from repro.models.attention import decode_attention
from repro_torch.parallel import sharding as TSH

T = 16
CASES = {"gemma3-12b": (20, 3, True), "jamba-v0.1-52b": (32, 3, True),
         "mixtral-8x22b": (20, 4, False)}  # arch -> (the cache's positions, batch, sequence-sharded)
WORLDS = {"2x1": ((2, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model"))}


def _state(cache):
    return {k: (type(c).__name__, {f: np.asarray(v) for f, v in zip(c._fields, c)}) for k, c in cache.items()}


@pytest.fixture(scope="module")
def attn(tmp_path_factory):
    rng = np.random.default_rng(0)
    S, cl = 32, 23
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    pos = rng.permutation(np.arange(-6, S - 6))[None].repeat(2, 0).astype(np.int32)  # -1..-6: empty slots
    handle = TDist.spawn_ranks(TDist.seq_attention_runs, 4, tmp_path_factory.mktemp("seq_attn"), q, k, v, cl, pos)
    want = (decode_attention(q, k, v, jnp.int32(cl)), decode_attention(q, k, v, jnp.int32(cl), kv_positions=pos))
    return dict(port=TDist.collect(handle), want=[np.asarray(w) for w in want])


@pytest.mark.parametrize("which", ("plain", "placed"))
def test_seq_sharded_attention_matches_decode_attention(attn, which):
    want = attn["want"][0 if which == "plain" else 1]
    for r in attn["port"]:
        np.testing.assert_allclose(r[which], want, **FWD)


@pytest.fixture(scope="module")
def decode(tmp_path_factory):
    rng = np.random.default_rng(1)
    runs, want = [], {}
    for arch, (max_len, B, seq) in CASES.items():
        cfg = JC.smoke_config(arch)
        params = lm_params(cfg)
        tokens = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
        _, cache = jit(lambda p, b, cfg=cfg, n=max_len: JLM.prefill(p, cfg, b, q_chunk=8, max_len=n))(
            params, {"tokens": tokens[:, : T - 1]})
        runs.append((arch, arch, params, _state(cache), tokens[:, T - 1 :], T - 1, seq))
        want[arch] = jit(lambda p, c, tok, n, cfg=cfg: JLM.decode_step(p, cfg, c, tok, n))(
            params, cache, tokens[:, T - 1 :], jnp.int32(T - 1))
    handles = {w: TDist.spawn_ranks(TDist.lm_decode_runs, int(np.prod(s)), tmp_path_factory.mktemp(f"decode{w}"), s, ax,
                                    runs) for w, (s, ax) in WORLDS.items()}
    return dict(port={w: TDist.collect(h) for w, h in handles.items()}, want=want)


@pytest.mark.parametrize("arch", sorted(CASES))
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_mesh_decode_step_matches_the_reference(decode, world, arch):
    max_len, B, seq = CASES[arch]
    mesh = StandIn(*WORLDS[world])
    want_logits, want_cache = decode["want"][arch]
    specs = TSH.cache_specs(TC.smoke_config(arch), TC.ShapeConfig("decode_test", max_len, B, "decode"), mesh,
                            seq_shard=seq)
    split = {"data": 0, "model": 0}
    for r in decode["port"][world]:
        got = r[arch]
        rows = np_block(np.asarray(want_logits), TSH.P(None if seq else ("data",), None), r["coords"], mesh.shape)
        np.testing.assert_allclose(got["logits"], rows, **FWD)
        for slot, c in want_cache.items():
            kind, fields = got["cache"][slot]
            assert kind == type(c).__name__
            for f, leaf in zip(c._fields, c):
                spec = getattr(specs[slot], f)
                for ax in split:  # leaves this mesh splits over each axis
                    split[ax] += ax in spec and mesh.shape[ax] > 1
                want = np_block(np.asarray(leaf), spec, r["coords"], mesh.shape)
                np.testing.assert_allclose(fields[f], want, **FWD, err_msg=f"{world} {arch} {slot}.{f}")
    assert split["data"] > 0  # the sequence (or the batch) really was split
    assert (split["model"] > 0) == (mesh.shape["model"] > 1)
