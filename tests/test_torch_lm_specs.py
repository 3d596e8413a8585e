"""The LM half of the port's ``parallel/sharding.py`` against the
reference's, on stand-in meshes (what the rules read of a mesh: ``shape``
and ``axis_names``) of 4x2, 2x2x2 and the production 16x16, for all ten LM
archs, with and without ``moe_ep``: ``lm_param_specs`` (the specs and the
fallback lines), ``opt_specs`` of them, ``lm_batch_specs`` at every shape,
and ``cache_specs`` at every shape with and without ``seq_shard``.  A mesh
without a "model" axis is refused with ``ValueError``."""
import dataclasses

import pytest

import repro.configs as JC
import repro_torch.configs as TC
from _lm_pair import StandIn
from repro.parallel import sharding as JSH
from repro_torch.parallel import sharding as TSH

MESHES = {"4x2": ((4, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model"))}


def _same(port, ref, path=""):
    if isinstance(port, TSH.PartitionSpec):
        assert tuple(port) == tuple(ref), (path, port, ref)
        return
    if isinstance(port, tuple):  # the NamedTuples: caches, OptState
        assert type(port).__name__ == type(ref).__name__ and port._fields == ref._fields, path
        for f, a, b in zip(port._fields, port, ref):
            _same(a, b, f"{path}.{f}")
        return
    assert set(port) == set(ref), path
    for k in port:
        _same(port[k], ref[k], f"{path}.{k}")


def _cfgs(arch, ep):
    return dataclasses.replace(JC.LMS[arch], moe_ep=ep), dataclasses.replace(TC.LMS[arch], moe_ep=ep)


@pytest.mark.parametrize("ep", (False, True), ids=("fsdp_experts", "moe_ep"))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JC.LMS))
def test_lm_param_and_opt_specs_match_the_reference(arch, mesh, ep):
    m = StandIn(*MESHES[mesh])
    jcfg, tcfg = _cfgs(arch, ep)
    (js, jfb), (ts, tfb) = JSH.lm_param_specs(jcfg, m), TSH.lm_param_specs(tcfg, m)
    _same(ts, js)
    assert tfb == jfb
    _same(TSH.opt_specs(ts), JSH.opt_specs(js))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JC.LMS))
def test_lm_batch_and_cache_specs_match_the_reference(arch, mesh):
    m = StandIn(*MESHES[mesh])
    jcfg, tcfg = JC.LMS[arch], TC.LMS[arch]
    for name in JC.SHAPES:
        _same(TSH.lm_batch_specs(tcfg, TC.SHAPES[name], m), JSH.lm_batch_specs(jcfg, JC.SHAPES[name], m), name)
        for seq in (False, True):
            _same(TSH.cache_specs(tcfg, TC.SHAPES[name], m, seq_shard=seq),
                  JSH.cache_specs(jcfg, JC.SHAPES[name], m, seq_shard=seq), f"{name} seq_shard={seq}")


def test_fallback_lines_are_logged_where_heads_do_not_divide():
    # qwen2-vl's 12 heads and llama4's 40 do not divide a TP extent of 16 (the reference's DESIGN note)
    for arch in ("qwen2-vl-2b", "llama4-scout-17b-a16e"):
        _, fb = TSH.lm_param_specs(TC.LMS[arch], StandIn(*MESHES["16x16"]))
        assert any("heads !% tp -> replicated attn" in line for line in fb), arch


def test_lm_specs_refuse_a_mesh_without_a_model_axis():
    m = StandIn((4,), ("data",))
    cfg, shape = TC.LMS["llama3-8b"], TC.SHAPES["train_4k"]
    for call in (lambda: TSH.lm_param_specs(cfg, m), lambda: TSH.lm_batch_specs(cfg, shape, m),
                 lambda: TSH.cache_specs(cfg, shape, m)):
        with pytest.raises(ValueError, match="'model' axis"):
            call()
