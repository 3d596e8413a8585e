"""Sharded GAN residency: ``prepack_generator`` / ``prepack_discriminator``
/ ``register_prepacked_generator`` / ``GanServeEngine`` with ``mesh=``, on
4 spawned gloo ranks on the CPU, a (2, 2) ("data", "model") mesh, against
the reference's placement and images on a 4-host-device JAX mesh (a JAX
subprocess, as test_torch_compression.py runs one).

* each rank's blocks are ``block_of`` of the unsharded packed trees, gather
  back to them, and equal the reference's shard on the device of the same
  index (packing rounds alike: 1e-6);
* the images of a sharded generate (and of an engine serving a registry
  entry registered on the mesh) equal JAX's ``generator_apply`` on the
  sharded packed tree at the serve tolerances, atol 1e-5 / rtol 1e-4;
* a rank holds its blocks at rest, fewer bytes than the whole tree;
* a fault raised on one rank only, during a sharded generate, fails every
  rank's request within the process group's timeout (5 s here) instead of
  hanging it.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

import _torch_dist as TDist
from repro.configs import gan_zoo as jzoo
from repro.models import gan as JG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE, AXES = (2, 2), ("data", "model")
ZOO = ("cuda_chained", "cuda_chained")
PG_TIMEOUT_S = 5.0

JAX_SHARDED = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import gan_zoo
from repro.models import gan as G

src, dst = sys.argv[1], sys.argv[2]
d = dict(np.load(src))

def tree(prefix):
    out = {}
    for k, v in d.items():
        if k.startswith(prefix):
            layer, leaf = k[len(prefix):].split("/")
            out.setdefault(layer, {})[leaf] = jnp.asarray(v)
    return out

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
cfg = gan_zoo.tiny_dcgan("prepacked_ref", "prepacked_ref")
gp = G.prepack_generator(tree("gp/"), cfg, mesh=mesh)
dp = G.prepack_discriminator(tree("dp/"), cfg, mesh=mesh)
img, _ = G.generator_apply(gp, cfg, jnp.asarray(d["z"]), training=False)
out = {"img": np.asarray(img)}
for name, t in (("gp", gp), ("dp", dp)):
    for layer, leaves in t.items():
        for leaf, arr in leaves.items():
            for shard in arr.addressable_shards:
                out[f"{name}/{layer}/{leaf}/{shard.device.id}"] = np.asarray(shard.data)
np.savez(dst, **out)
"""


def _numpy_case():
    """A tiny DCGAN tree (raw weights) in the layout of JAX's init (its
    shapes from ``jax.eval_shape``; JAX's own init compiles op by op, ~15 s
    here), drawn from numpy: weights N(0, 0.02²), non-zero biases and
    non-trivial eval-mode batchnorm statistics; and a batch of 3 latents."""
    cfg = jzoo.tiny_dcgan()
    rng = np.random.default_rng(0)

    def draw(kp, s):
        name, n = jax.tree_util.keystr(kp), rng.standard_normal(s.shape).astype(np.float32)
        if name.endswith("['scale']") or name.endswith("['var']"):
            return (1 + 0.1 * np.abs(n)).astype(np.float32)
        return ((0.02 if name.endswith("['w']") else 0.1) * n).astype(np.float32)

    gp, dp = (jax.tree_util.tree_map_with_path(draw, jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0)))
              for init in (JG.generator_init, JG.discriminator_init))
    z = rng.standard_normal((3, cfg.z_dim)).astype(np.float32)
    return gp, dp, z


LINGERS = (0.0, PG_TIMEOUT_S + 3)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world of this file at once (they share nothing), the longest
    started first: the JAX subprocess, a fault world per linger, the
    sharded runs.  A rank's seconds are measured in the rank."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    gp, dp, z = _numpy_case()
    flat = {f"{n}/{layer}/{leaf}": v for n, t in (("gp", gp), ("dp", dp)) for layer, leaves in t.items()
            for leaf, v in leaves.items()}
    np.savez(tmp / "in.npz", z=z, **flat)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_SHARDED), str(tmp / "in.npz"),
                             str(tmp / "out.npz")], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)
    faults = {linger: TDist.spawn_ranks(TDist.serve_mesh_fault, 4, tmp, SHAPE, AXES, ZOO, gp, dp, z, 1, linger,
                                        pg_timeout=PG_TIMEOUT_S) for linger in sorted(LINGERS, reverse=True)}
    handle = TDist.spawn_ranks(TDist.serve_mesh_runs, 4, tmp, SHAPE, AXES, ZOO, gp, dp, z)
    out = {"faults": {linger: TDist.collect(h, deadline=60) for linger, h in faults.items()},
           "port": TDist.collect(handle)}
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    out["jax"] = dict(np.load(tmp / "out.npz"))
    return out


def test_each_rank_holds_block_of_the_unsharded_tree(worlds):
    for rank, r in enumerate(worlds["port"]):
        assert r["blocks_ok"] and r["gathered_ok"], rank
        for name in ("gp", "dp"):
            for layer, leaves in r[name[0] + "blk"].items():
                for leaf, block in leaves.items():
                    want = worlds["jax"][f"{name}/{layer}/{leaf}/{rank}"]
                    assert block.shape == want.shape, (rank, name, layer, leaf)
                    np.testing.assert_allclose(block, want, atol=1e-6, rtol=0, err_msg=f"{rank} {name}.{layer}")


def test_sharded_generate_matches_the_reference(worlds):
    for r in worlds["port"]:
        np.testing.assert_allclose(r["img"], worlds["jax"]["img"], atol=1e-5, rtol=1e-4)
        np.testing.assert_array_equal(r["img_registry"], r["img"])
        assert r["healthy"]


def test_a_rank_holds_its_blocks_at_rest(worlds):
    """The split leaves (N over "data", M over "model" where they divide)
    are a quarter of their size on each rank; the last layer's M = 3 and
    the batchnorm leaves replicate, and the fallback log says so."""
    for r in worlds["port"]:
        assert r["resident_bytes"] < 0.5 * r["full_bytes"]
        assert any(line.startswith("deconv3.M: 3 % model(2)") for line in r["fallbacks"])
    assert len({r["resident_bytes"] for r in worlds["port"]}) == 1


@pytest.mark.parametrize("linger_s", LINGERS)
def test_a_fault_on_one_rank_fails_every_rank_within_the_timeout(worlds, linger_s):
    """Rank 1 raises before its gather.  Its request fails at once; the
    other ranks wait in the gather and fail too: at once when rank 1's
    process ends (its connections close), and at the process group's
    timeout while it lingers.  No rank hangs, and every failure is the
    engine's carried ``GanServeError``."""
    out = worlds["faults"][linger_s]
    assert "injected fault on rank 1" in out[1]["outcome"] and out[1]["seconds"] < 1
    for rank, r in enumerate(out):
        assert r["outcome"].startswith("GanServeError"), (rank, r["outcome"])
        assert r["seconds"] < PG_TIMEOUT_S + 3, (rank, r["seconds"])
        if linger_s and rank != 1:  # the peers waited for the timeout
            assert r["seconds"] >= PG_TIMEOUT_S - 0.5, (rank, r["seconds"])


def test_make_mesh_refuses_a_torch_that_hides_the_timeout(monkeypatch):
    """Where the default group's timeout cannot be read, make_mesh raises
    rather than give its groups torch's 30-minute default."""
    from repro_torch.launch import mesh as M

    monkeypatch.setattr(M.dist.distributed_c10d, "_get_default_group", lambda: object())
    with pytest.raises(RuntimeError, match="timeout"):
        M._world_timeout("gloo")
