"""The port's ``parallel/sharding.py``, ``launch/mesh.py`` and the mesh
train step (``make_gan_step(mesh=...)``), on the CPU: ranks are gloo
processes (``_torch_dist.spawn_ranks``), every spawn under a deadline.

* The specs: ``gan_param_specs`` / ``gan_batch_specs`` /
  ``audio_decoder_param_specs`` / ``opt_specs`` for the four ``gan_zoo``
  archs and the audio decoder against the JAX functions, on a stand-in
  mesh object (``shape`` / ``axis_names``) of 4x2 and 2x2x2: the same specs
  and the same fallback lines.
* The mesh: on (2, 2) every axis's group holds the ranks that share the
  other coordinate, row-major; a mesh the world does not hold is refused,
  and so is NCCL with every rank on one card (ValueError naming both
  backends);
  ``block_of`` / ``gather`` round-trip under every spec shape, each block
  the reference's major-to-minor slice.
* The mesh step: ``tiny_dcgan`` per layer on packed weights (the port's
  ``cuda_prepacked`` on CPU tensors: the plain versions; JAX's
  ``prepacked_ref``), batch 8 on worlds 2 and (2, 2): 3 steps against JAX's
  single-device ``make_gan_step`` on the same numpy inputs (metrics 1e-3
  relative, parameters 6·lr, running statistics 1e-3), the packed leaves
  really split; batch 3 on world 2, which does not divide: both inputs
  replicate, the fallback is in the log, and the run matches the port's
  single-device steps at batch 3 (which the single-device tests hold to
  JAX's) to the same tolerances.
* ``autotune_deconv(mesh=..., mode="step")``, with and without
  ``grad_compression="int8"``, on (2, 2)."""
import dataclasses

import numpy as np
import pytest

import _parallel_ref as REF
import _torch_dist as TDist
from repro.configs import gan_zoo as jzoo
from repro.configs import musicgen_medium as jmm
from repro.parallel import sharding as JSH
from repro_torch.configs import gan_zoo as tzoo
from repro_torch.configs import musicgen_medium as tmm
from repro_torch.launch import make_mesh, make_production_mesh
from repro_torch.parallel import sharding as TSH
from repro_torch.train import StepSettings, make_gan_step


class StandIn:
    """What the spec rules read of a mesh."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


MESHES = {"4x2": ((4, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
IMPLS = (("prepacked_ref", "lax"), ("ref", "lax"), ("chained_ref", "chained_ref"), ("prepacked_ref", "prepacked_ref"))


def _same_specs(port, ref, path=""):
    if isinstance(port, TSH.PartitionSpec):
        assert tuple(port) == tuple(ref), path
        return
    assert set(port) == set(ref), path
    for k in port:
        _same_specs(port[k], ref[k], f"{path}.{k}")


@pytest.mark.parametrize("impls", IMPLS, ids="/".join)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(tzoo.GANS))
def test_gan_param_and_opt_specs_match_the_reference(arch, mesh, impls):
    m = StandIn(*MESHES[mesh])
    tcfg = dataclasses.replace(tzoo.GANS[arch], deconv_impl=impls[0], conv_impl=impls[1])
    jcfg = dataclasses.replace(jzoo.GANS[arch], deconv_impl=impls[0], conv_impl=impls[1])
    tg, td, tfb = TSH.gan_param_specs(tcfg, m)
    jg, jd, jfb = JSH.gan_param_specs(jcfg, m)
    _same_specs(tg, jg)
    _same_specs(td, jd)
    assert tfb == jfb and any("deconv" in f and ".M" in f for f in tfb) == ("model" in m.axis_names)
    osp = TSH.opt_specs(tg)
    assert osp.m is tg and osp.v is tg and tuple(osp.step) == tuple(JSH.opt_specs(jg).step) == ()


@pytest.mark.parametrize("batch", (8, 6, 3))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(tzoo.GANS))
def test_gan_batch_specs_match_the_reference(arch, mesh, batch):
    m = StandIn(*MESHES[mesh])
    t = TSH.gan_batch_specs(tzoo.GANS[arch], batch, m)
    j = JSH.gan_batch_specs(jzoo.GANS[arch], batch, m)
    assert [tuple(s) for s in t[:2]] == [tuple(s) for s in j[:2]] and t[2] == j[2]
    assert bool(t[2]) == (batch % 4 != 0)


@pytest.mark.parametrize("packed", (False, True))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("width", (4, 64))
def test_audio_decoder_specs_match_the_reference(width, mesh, packed):
    m = StandIn(*MESHES[mesh])
    t, tfb = TSH.audio_decoder_param_specs(tmm.audio_decoder(width), m, packed=packed)
    j, jfb = JSH.audio_decoder_param_specs(jmm.audio_decoder(width), m, packed=packed)
    _same_specs(t, j)
    assert tfb == jfb and any("audio.deconv2.M" in f for f in tfb) == ("model" in m.axis_names)


def test_spec_canonical_form_and_production_shapes():
    assert tuple(TSH.P(None, ("data",), "model")) == (None, "data", "model")
    assert tuple(TSH.P(("pod", "data"), None)) == (("pod", "data"), None)
    assert make_production_mesh() == ((16, 16), ("data", "model"))
    assert make_production_mesh(multi_pod=True) == ((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1,), ("data",), device="cpu")


# ---------------------------------------------------------------- the mesh
SPECS = ((("data", "model"), None), (None, "model"), ("model", "data"), ("data", None), (None, None),
         (None, ("model", "data")))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    tmp = tmp_path_factory.mktemp("w4")
    checks = TDist.spawn_ranks(TDist.mesh_checks, 4, tmp, (2, 2), ("data", "model"), x, SPECS)
    tuned = TDist.spawn_ranks(TDist.autotune_runs, 4, tmp, (2, 2), ("data", "model"))
    return dict(x=x, checks=TDist.collect(checks), tuned=TDist.collect(tuned))


def test_mesh_groups_are_row_major(world4):
    for rank, c in enumerate(world4["checks"]):
        assert c["coords"] == {"data": rank // 2, "model": rank % 2}
        assert c["groups"] == {"data": [rank % 2, rank % 2 + 2], "model": [rank - rank % 2, rank - rank % 2 + 1]}
        assert c["extent"] == 4 and c["index"] == rank
        assert "5 ranks, the world 4" in c["refused"]
        assert "backend 'nccl' needs one card per rank" in c["shared"] and "gloo" in c["shared"]


def _ref_block(x, spec, coords, shape):
    """The reference's major-to-minor block of ``x`` under ``spec``."""
    out = x
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        n, idx = 1, 0
        for a in names:
            n *= shape[a]
            idx = idx * shape[a] + coords[a]
        blk = out.shape[dim] // n
        out = np.take(out, range(idx * blk, (idx + 1) * blk), axis=dim)
    return out


def test_blocks_round_trip_under_every_spec(world4):
    for c in world4["checks"]:
        for sp in SPECS:
            want = _ref_block(world4["x"], sp, c["coords"], {"data": 2, "model": 2})
            np.testing.assert_array_equal(c["blocks"][str(sp)], want, err_msg=str(sp))
            np.testing.assert_array_equal(c["back"][str(sp)], world4["x"], err_msg=str(sp))


def test_autotune_times_the_step_on_a_mesh(world4):
    for rank_rows in world4["tuned"]:
        for gc in (None, "int8"):
            rows = rank_rows[gc]
            assert len(rows) == 2 and all(r["ok"] for r in rows), rows
            if gc is None:  # every dim divides: nothing replicated
                assert all(r["sharding_fallbacks"] == [] for r in rows), rows
            else:
                assert all("sharding_fallbacks" not in r for r in rows)


# ------------------------------------------------------------ the mesh step
ZOO = ("prepacked_ref",)
PORT_ZOO = ("cuda_prepacked",)


def _port_steps(gp, dp, data):
    """The port's single-device steps on the same inputs."""
    import torch

    from repro_torch.convert import discriminator_params_from_numpy, generator_params_from_numpy
    from repro_torch.optim import adamw_init

    cfg = tzoo.tiny_dcgan(*PORT_ZOO)
    g, d = generator_params_from_numpy(gp, cfg, device="cpu"), discriminator_params_from_numpy(dp, cfg, device="cpu")
    go, do = adamw_init(g), adamw_init(d)
    step, metrics = make_gan_step(cfg, settings=StepSettings(lr=REF.LR, b1=0.5)), []
    for z, real in data:
        g, d, go, do, m = step(g, d, go, do, torch.tensor(z), torch.tensor(real))
        metrics.append({k: float(v) for k, v in m.items()})
    as_np = lambda t: {k: {kk: v.numpy() for kk, v in leaf.items()} for k, leaf in t.items()}  # noqa: E731
    return dict(metrics=metrics, gp=as_np(g), dp=as_np(d))


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    jcfg, gp, dp = REF.start(ZOO)
    data8, data3 = REF.batches(jcfg, 8), REF.batches(jcfg, 3)
    tmp = tmp_path_factory.mktemp("mesh")
    w2 = TDist.spawn_ranks(TDist.sharded_runs, 2, tmp, (2,), ("data",), PORT_ZOO, gp, dp,
                           [("b8", "mesh", None, data8), ("b3", "mesh", None, data3)])
    w4 = TDist.spawn_ranks(TDist.sharded_runs, 4, tmp, (2, 2), ("data", "model"), PORT_ZOO, gp, dp,
                           [("b8", "mesh", None, data8)])
    ref = {8: REF.steps(jcfg, gp, dp, data8), 3: _port_steps(gp, dp, data3)}  # while the ranks run
    return dict(ref=ref, runs={"2": TDist.collect(w2), "2x2": TDist.collect(w4)})


@pytest.mark.parametrize("world", ("2", "2x2"))
def test_mesh_step_matches_the_single_device_reference(mesh_runs, world):
    ref = mesh_runs["ref"][8]
    for r in mesh_runs["runs"][world]:
        REF.check_metrics(r["b8"]["metrics"], ref["metrics"])
        REF.check_params(r["b8"]["gp"], ref["gp"])
        REF.check_params(r["b8"]["dp"], ref["dp"])


@pytest.mark.parametrize("world", ("2", "2x2"))
def test_mesh_step_splits_the_packed_leaves(mesh_runs, world):
    """deconv0's packed (C, 16, 8) leaf: N over data; M over model on 2x2."""
    for r in mesh_runs["runs"][world]:
        C = r["b8"]["gp"]["deconv0"]["ww"].shape[0]
        assert r["b8"]["blocks"] == {"ww": (C, 8, 4 if world == "2x2" else 8)}
        assert r["b8"]["g_plan"].covers_exactly_once() and len(r["b8"]["g_plan"].buckets) == \
            r["b8"]["g_plan"].n_leaves  # the mesh step reduces leaf by leaf


def test_mesh_step_replicates_a_batch_that_does_not_divide(mesh_runs):
    ref = mesh_runs["ref"][3]
    for r in mesh_runs["runs"]["2"]:
        assert "gan.batch: 3 % ('data',)(2) != 0 -> replicated" in r["b3"]["fallbacks"]
        REF.check_metrics(r["b3"]["metrics"], ref["metrics"])
        REF.check_params(r["b3"]["gp"], ref["gp"])
        REF.check_params(r["b3"]["dp"], ref["dp"])


def test_mesh_step_needs_the_global_batch():
    with pytest.raises(ValueError, match="batch"):
        make_gan_step(tzoo.tiny_dcgan(), settings=StepSettings(mesh=StandIn((2,), ("data",))))
    with pytest.raises(ValueError, match="require mesh and batch"):
        make_gan_step(tzoo.tiny_dcgan(), settings=StepSettings(overlap=True, batch=8))
