"""The expert-parallel MoE (``models/moe.py::moe_apply_ep``) on world
(4, 1) ("data", "model"), one expert a data shard, against JAX's own
``moe_apply_ep`` under ``shard_map`` on 4 host devices in a subprocess
(``--xla_force_host_platform_device_count=4``, the reference tests' own
way), on the same numpy inputs: mixtral-8x22b's MoE at ``smoke_config``
(E = 4, top-2, swiglu) at capacity factor 1.0, 8 rows of 4 tokens, so that
assignments drop (asserted).  The outputs and the aux loss (the sum of the
ranks' shares) within atol 1e-5 / rtol 1e-4; the gradients of sum(out *
ct) + aux in x and in every weight (the ranks' sum) within 1e-4 of the
largest plus 1e-5: the gradient flows through both all-to-alls."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import _torch_dist as TDist
from _lm_pair import FWD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, CF = "mixtral-8x22b", 1.0

JAX_EP = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.configs import smoke_config
from repro.models import moe as M

src, dst, arch, cf = sys.argv[1], sys.argv[2], sys.argv[3], float(sys.argv[4])
cfg = smoke_config(arch)
spec = dataclasses.replace(cfg.moe, capacity_factor=cf)
a = dict(np.load(src))
p = {k: {"w": jnp.asarray(a[k])} for k in ("router", "up", "gate", "down")}
mesh = make_mesh((4, 1), ("data", "model"))
fn = lambda p, x: M.moe_apply_ep(p, x, spec, cfg.mlp, mesh=mesh)
loss = lambda p, x: (lambda o: jnp.sum(o[0] * a["ct"]) + o[1])(fn(p, x))
out, aux = jax.jit(fn)(p, a["x"])
dp, dx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, a["x"])
np.savez(dst, out=np.asarray(out), aux=np.asarray(aux), dx=np.asarray(dx),
         **{"d_" + k: np.asarray(v["w"]) for k, v in dp.items()})
"""


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    rng = np.random.default_rng(0)
    D, F, E = 64, 128, 4
    w = {"router": rng.standard_normal((D, E)) / 8, "up": rng.standard_normal((E, D, F)) / 8,
         "gate": rng.standard_normal((E, D, F)) / 8, "down": rng.standard_normal((E, F, D)) / 11}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((8, 4, D)).astype(np.float32)
    ct = rng.standard_normal((8, 4, D)).astype(np.float32)
    handle = TDist.spawn_ranks(TDist.moe_ep_runs, 4, tmp, ARCH, CF, {k: {"w": v} for k, v in w.items()}, x, ct)
    np.savez(tmp / "in.npz", x=x, ct=ct, **w)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_EP), str(tmp / "in.npz"), str(tmp / "out.npz"),
                           ARCH, str(CF)], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(port=TDist.collect(handle), jax=dict(np.load(tmp / "out.npz")))


def test_ep_drops_assignments(ep):
    assert sum(r["drops"] for r in ep["port"]) > 0


def test_ep_output_and_aux_match_the_reference(ep):
    np.testing.assert_allclose(np.concatenate([r["out"] for r in ep["port"]]), ep["jax"]["out"], **FWD)
    np.testing.assert_allclose(sum(r["aux"] for r in ep["port"]), float(ep["jax"]["aux"]), **FWD)


@pytest.mark.parametrize("leaf", ("x", "router", "up", "gate", "down"))
def test_ep_gradients_match_the_reference(ep, leaf):
    if leaf == "x":
        got, want = np.concatenate([r["dx"] for r in ep["port"]]), ep["jax"]["dx"]
    else:
        got, want = sum(r["dp"][leaf]["w"] for r in ep["port"]), ep["jax"]["d_" + leaf]
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max() + 1e-5, rtol=0)
