"""The port's ``parallel/compression.py`` and the int8-compressed overlap
step on the CPU (gloo ranks from ``_torch_dist``, every spawn under a
deadline).

* ``wire_bytes_saved`` counts each leaf at its own dtype, as JAX's does.
* ``compressed_psum`` on 4 ranks equals the JAX function run under
  ``shard_map`` on 4 host devices in a subprocess
  (``--xla_force_host_platform_device_count=4``, the reference tests' own
  way), outputs and residuals within 1e-6, on a tree of two leaves; the
  output is the numpy mirror of the wire format's dequantized sum, and every
  rank holds the same bits.
* Error feedback: 32 reductions of one gradient with the residual threaded
  through average to the true mean within 1.5 * scale / 32 (the
  reference's bound), well under the one-shot error.
* The compressed step (``build_gan_comm_step(grad_compression="int8")``):
  ``tiny_dcgan`` per layer on packed weights (the port's ``cuda_prepacked``
  on CPU tensors; JAX's ``prepacked_ref``), batch 8 on worlds 2 and (2, 2),
  3 steps against JAX's single-device ``make_gan_step``: losses within
  2e-2, parameters within 5e-3 (the reference's compression tolerances),
  and the residual state live after the steps."""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _parallel_ref as REF
import _torch_dist as TDist
from repro.parallel.compression import wire_bytes_saved as jwire_bytes_saved
from repro_torch.parallel import compression as TC
from repro_torch.tree import flat_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_wire_bytes_saved_counts_actual_dtypes():
    g32, g16 = torch.zeros(10), torch.zeros(10, dtype=torch.bfloat16)
    assert TC.wire_bytes_saved([g32]) == 10 * 3 == jwire_bytes_saved([jnp.zeros((10,), jnp.float32)])
    assert TC.wire_bytes_saved([g16]) == 10 * 1 == jwire_bytes_saved([jnp.zeros((10,), jnp.bfloat16)])
    assert TC.wire_bytes_saved({"a": g32, "b": g16}) == 40
    assert TC.wire_bytes_saved([np.zeros((3, 4), np.float32)]) == 36


def test_init_residuals_and_tree_order():
    tree = {"b": torch.ones(2, dtype=torch.bfloat16), "a": {"y": torch.ones(3), "x": torch.ones(1, 2)}}
    res = TC.init_residuals(tree)
    assert list(res) == ["b", "a"] and list(res["a"]) == ["y", "x"]
    assert all(r.dtype == torch.float32 and not r.any() for r in flat_leaves(res))
    assert [tuple(t.shape) for t in flat_leaves(tree)] == [(1, 2), (3,), (2,)]  # JAX's order: keys sorted


JAX_PSUM = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.parallel.compression import compressed_psum

src, dst = sys.argv[1], sys.argv[2]
g = dict(np.load(src))
n = 4
mesh = make_mesh((n,), ("data",))
spec = {k: P("data") for k in g}
fn = shard_map(lambda gs, rs: compressed_psum(gs, rs, "data", axis_size=n), mesh=mesh,
               in_specs=(spec, spec), out_specs=(spec, spec), check_vma=False)
out, res = fn({k: jnp.asarray(v) for k, v in g.items()}, {k: jnp.zeros_like(jnp.asarray(v)) for k, v in g.items()})
np.savez(dst, **{"out_" + k: np.asarray(v) for k, v in out.items()}, **{"res_" + k: np.asarray(v) for k, v in res.items()})
"""


@pytest.fixture(scope="module")
def psum(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("psum")
    rng = np.random.default_rng(0)
    g_one = {"w": np.asarray(rng.standard_normal((4, 1, 5, 33)), np.float32),
             "b": np.asarray(0.01 * rng.standard_normal((4, 1, 7)), np.float32)}
    g_loop = np.asarray(np.random.default_rng(1).standard_normal((4, 64)), np.float32)
    handle = TDist.spawn_ranks(TDist.compression_runs, 4, tmp, g_one, g_loop, 32)
    np.savez(tmp / "g.npz", **g_one)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_PSUM), str(tmp / "g.npz"), str(tmp / "j.npz")],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    jax_out = dict(np.load(tmp / "j.npz"))
    return dict(g_one=g_one, g_loop=g_loop, port=TDist.collect(handle), jax=jax_out)


def test_compressed_psum_matches_the_reference(psum):
    for rank, r in enumerate(psum["port"]):
        for k in psum["g_one"]:
            np.testing.assert_allclose(r["out"][k], psum["jax"]["out_" + k][rank], rtol=0, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(r["res"][k], psum["jax"]["res_" + k][rank], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("leaf", ("w", "b"))
def test_compressed_psum_is_the_dequantized_sum(psum, leaf):
    g = psum["g_one"][leaf]
    scale = np.float32(max(np.abs(g).max(), 1e-8) / 127.0)
    q = np.clip(np.round(g / scale), -127, 127).astype(np.int32)
    want = q.sum(axis=0).astype(np.float32) * scale / np.float32(4)
    for rank, r in enumerate(psum["port"]):
        np.testing.assert_allclose(r["out"][leaf], want, rtol=0, atol=1e-7)
        np.testing.assert_array_equal(r["out"][leaf], psum["port"][0]["out"][leaf])
        np.testing.assert_allclose(r["res"][leaf], g[rank] - q[rank].astype(np.float32) * scale, rtol=0, atol=1e-7)
        assert np.abs(r["res"][leaf]).max() > 0


def test_error_feedback_unbiased_over_steps(psum):
    g, T = psum["g_loop"], 32
    true_mean = g.mean(axis=0)
    scale = np.abs(g).max() / 127.0
    for r in psum["port"]:
        first_err = np.abs(r["first"] - true_mean).max()
        err = np.abs(r["acc"] / T - true_mean).max()
        assert err <= 1.5 * scale / T, (err, scale / T)
        assert err < first_err / 4, (err, first_err)


# ------------------------------------------------------- the compressed step
@pytest.fixture(scope="module")
def int8_runs(tmp_path_factory):
    jcfg, gp, dp = REF.start(("prepacked_ref",))
    data = REF.batches(jcfg, 8)
    tmp = tmp_path_factory.mktemp("int8")
    todo = [("int8", "int8", None, data), ("int8_small", "int8", 8192, data)]
    w2 = TDist.spawn_ranks(TDist.sharded_runs, 2, tmp, (2,), ("data",), ("cuda_prepacked",), gp, dp, todo)
    w4 = TDist.spawn_ranks(TDist.sharded_runs, 4, tmp, (2, 2), ("data", "model"), ("cuda_prepacked",), gp, dp, todo)
    ref = REF.steps(jcfg, gp, dp, data)  # while the ranks run
    return dict(ref=ref, port={"2": TDist.collect(w2), "2x2": TDist.collect(w4)})


@pytest.mark.parametrize("run", ("int8", "int8_small"))
@pytest.mark.parametrize("world", ("2", "2x2"))
def test_compressed_step_tracks_the_single_device_reference(int8_runs, world, run):
    ref = int8_runs["ref"]
    for rank in int8_runs["port"][world]:
        r = rank[run]
        for a, b in zip(r["metrics"], ref["metrics"]):
            assert a["nonfinite"] == 0.0
            assert abs(a["g_loss"] - b["g_loss"]) < 2e-2 and abs(a["d_loss"] - b["d_loss"]) < 2e-2, (a, b)
        for net in ("gp", "dp"):
            for k, leaf in r[net].items():
                for kk, v in leaf.items():
                    np.testing.assert_allclose(v, ref[net][k][kk], atol=5e-3, rtol=5e-3, err_msg=f"{net}.{k}.{kk}")
        assert r["residual_max"] > 0  # error feedback engaged
    assert json.dumps(int8_runs["port"][world][0][run]["metrics"]) == \
        json.dumps(int8_runs["port"][world][-1][run]["metrics"])  # every rank saw the same metrics
