"""The port's ``parallel/overlap.py`` on the CPU (gloo ranks from
``_torch_dist``, every spawn under a deadline).

* ``plan_buckets`` and ``wire_report`` equal the JAX ones on the same numpy
  trees: ``tiny_dcgan``'s and DCGAN's full-width generator and
  discriminator, at several bucket sizes.
* The overlap step (``build_gan_comm_step``) and the mesh step on the
  reference's main training path, ``tiny_dcgan`` chained on both nets (the
  port's ``cuda_chained`` on CPU tensors: the kernels' plain versions;
  JAX's ``chained_ref``), batch 8 on worlds 2 and (2, 2), at the default
  bucket size and at 8192 bytes (more than one generator bucket): 3 steps
  each against JAX's single-device ``make_gan_step`` on the same numpy
  inputs, metrics 1e-3 relative, parameters 6·lr, running statistics 1e-3.
* Bucketing invariance: the two plans' step-1 reduced gradients (AdamW's
  first moment over 1 - b1, gathered) agree within 1e-6 of the leaf's
  largest + 1e-7.  Parameters after 3 AdamW steps are not held to each
  other at that level: AdamW's early steps are ±lr on any gradient near
  zero, so a last-bit difference in a reduced gradient moves them by up to
  a few lr (the reference's own 1e-6 parameter check fails for that
  reason); they are held to the reference at 6·lr above.
* The refusals: a batch the data axes do not divide, a mesh without a data
  axis, an unknown compression."""
import jax
import numpy as np
import pytest

import _parallel_ref as REF
import _torch_dist as TDist
from repro.configs import gan_zoo as jzoo
from repro.models import gan as JG
from repro.parallel import overlap as JOV
from repro_torch.configs import gan_zoo as tzoo
from repro_torch.parallel import overlap as TOV

SIZES = (TOV.DEFAULT_BUCKET_BYTES, 8192, 1, 1 << 30)


def _zero_tree(tree):
    """numpy zeros with each leaf's shape and dtype, no memory behind them."""
    return jax.tree.map(lambda s: np.lib.stride_tricks.as_strided(np.zeros(1, s.dtype), s.shape, (0,) * len(s.shape)),
                        tree)


def _trees(name):
    cfg = jzoo.tiny_dcgan("chained_ref", "chained_ref") if name == "tiny" else jzoo.DCGAN
    key = jax.ShapeDtypeStruct((2,), np.uint32)
    return (_zero_tree(jax.eval_shape(lambda k: JG.generator_init(k, cfg), key)),
            _zero_tree(jax.eval_shape(lambda k: JG.discriminator_init(k, cfg), key)))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", ("tiny", "dcgan"))
def test_plan_buckets_match_the_reference(name, size):
    for tree in _trees(name):
        t, j = TOV.plan_buckets(tree, bucket_bytes=size), JOV.plan_buckets(tree, bucket_bytes=size)
        assert (t.buckets, t.numels, t.n_leaves) == (j.buckets, j.numels, j.n_leaves)
        assert t.covers_exactly_once()
        if size == 1:
            assert len(t.buckets) == t.n_leaves


@pytest.mark.parametrize("compression", (None, "int8"))
@pytest.mark.parametrize("name", ("tiny", "dcgan"))
def test_wire_report_matches_the_reference(name, compression):
    gp, dp = _trees(name)
    assert TOV.wire_report(gp, dp, grad_compression=compression) == \
        JOV.wire_report(gp, dp, grad_compression=compression)


class StandIn:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def test_overlap_step_refusals():
    cfg = tzoo.tiny_dcgan("cuda_chained", "cuda_chained")
    with pytest.raises(ValueError, match="must divide the data axes"):
        TOV.build_gan_comm_step(cfg, StandIn((4,), ("data",)), batch=6)
    with pytest.raises(ValueError, match="no \\('pod','data'\\) axes"):
        TOV.build_gan_comm_step(cfg, StandIn((2,), ("model",)), batch=8)
    with pytest.raises(ValueError, match="unknown grad_compression"):
        TOV.build_gan_comm_step(cfg, StandIn((2,), ("data",)), batch=8, grad_compression="fp8")


# ------------------------------------------------------------- the steps
RUNS = (("default", "overlap", None), ("small", "overlap", 8192), ("mesh", "mesh", None))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg, gp, dp = REF.start(("chained_ref", "chained_ref"))
    data = REF.batches(jcfg, 8)
    tmp = tmp_path_factory.mktemp("overlap")
    port = ("cuda_chained", "cuda_chained")
    todo = [(n, v, b, data) for n, v, b in RUNS]
    w2 = TDist.spawn_ranks(TDist.sharded_runs, 2, tmp, (2,), ("data",), port, gp, dp, todo)
    w4 = TDist.spawn_ranks(TDist.sharded_runs, 4, tmp, (2, 2), ("data", "model"), port, gp, dp, todo)
    ref = REF.steps(jcfg, gp, dp, data)  # while the ranks run
    return dict(ref=ref, port={"2": TDist.collect(w2), "2x2": TDist.collect(w4)})


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
@pytest.mark.parametrize("world", ("2", "2x2"))
def test_sharded_steps_match_the_single_device_reference(runs, world, run):
    ref = runs["ref"]
    for rank in runs["port"][world]:
        r = rank[run]
        REF.check_metrics(r["metrics"], ref["metrics"])
        REF.check_params(r["gp"], ref["gp"])
        REF.check_params(r["dp"], ref["dp"])


@pytest.mark.parametrize("world", ("2", "2x2"))
def test_bucket_plans_reduce_to_the_same_gradients(runs, world):
    for rank in runs["port"][world]:
        a, b = rank["default"], rank["small"]
        assert len(a["g_plan"].buckets) == 1 and len(b["g_plan"].buckets) > 1
        assert a["g_plan"].covers_exactly_once() and b["g_plan"].covers_exactly_once()
        for ta, tb in zip(a["first"], b["first"]):
            for k in ta:
                for kk, va in ta[k].items():
                    np.testing.assert_allclose(va, tb[k][kk], rtol=0, atol=1e-6 * np.abs(va).max() + 1e-7,
                                               err_msg=f"{k}.{kk}")


@pytest.mark.parametrize("world", ("2", "2x2"))
def test_every_rank_ends_on_the_same_params(runs, world):
    ranks = runs["port"][world]
    for run in (r[0] for r in RUNS):
        for other in ranks[1:]:
            for net in ("gp", "dp"):
                for k, leaf in ranks[0][run][net].items():
                    for kk, v in leaf.items():
                        np.testing.assert_array_equal(v, other[run][net][k][kk], err_msg=f"{run} {net}.{k}.{kk}")


def test_step1_gradients_match_the_reference(runs):
    """The reduced gradients of the default plan on world 2 against JAX's
    single-device step-1 gradients: 1e-3 of each leaf's largest, a bias right
    before a batch-statistics BN (exact gradient zero) 1e-5 of the net's."""
    for jgrads, tgrads in zip(runs["ref"]["first"], runs["port"]["2"][0]["default"]["first"]):
        top = max(float(np.abs(np.asarray(v)).max()) for leaf in jgrads.values() for v in leaf.values())
        for k, leaf in tgrads.items():
            for kk, v in leaf.items():
                want = np.asarray(jgrads[k][kk])
                exact_zero = kk == "b" and f"{k}_bn" in tgrads
                atol = 1e-5 * top if exact_zero else 1e-3 * np.abs(want).max()
                np.testing.assert_allclose(v, want, rtol=0, atol=atol, err_msg=f"{k}.{kk}")
