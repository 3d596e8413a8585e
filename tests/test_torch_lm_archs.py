"""The LM slice as a whole, port against JAX, for the eight archs without an
SSM at ``smoke_config`` (Mamba2 and Jamba: test_torch_lm_archs_ssm.py): one
numpy tree in JAX's layout (``_lm_pair.lm_params``) carried across by
``lm_params_from_numpy``, the same numpy batches.

* ``train_loss`` and its gradients against ``jax.value_and_grad`` (the
  port's backward runs through ``torch.utils.checkpoint``, as JAX's
  through ``jax.checkpoint``);
* ``prefill``'s logits and every cache leaf;
* ``decode_step``'s logits and cache, one token on from a prefill;
* the port's decode at a (B,) ``cache_len`` against JAX's decode of each
  row on its own (the serving slots' semantics).

Tolerances: forward atol 1e-5 / rtol 1e-4, gradients 1e-4 of the largest
magnitude plus 1e-5 (ROADMAP §3).
"""
import jax.numpy as jnp
import pytest
import torch

import repro.configs as JC
from _lm_arch_cases import check_prefill_decode, check_train, close_tree, make_case
from repro.models import lm as JLM
from repro.models import ssm as JS
import repro_torch.configs as TC
from repro_torch.models import lm as TLM
from repro_torch.models import ssm as TS

ARCHS = sorted(a for a, c in JC.LMS.items() if c.ssm is None)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    yield make_case(JC, TC, request.param, "direct")
    TS.set_conv_impl("direct")


def test_train_loss_and_gradients(case):
    check_train(case)


def test_prefill_then_decode(case):
    """Prefill T - 1 tokens (logits and cache), then decode token T - 1
    (logits and cache), also at one length a row."""
    check_prefill_decode(case)


class _DataOnlyMesh:
    """A mesh without a "model" axis: the LM refuses it (its rules read the
    TP extent; an LM mesh always has one, of extent 1 at least)."""

    shape = {"data": 2}
    axis_names = ("data",)


def test_lm_entry_points_refuse_a_mesh_without_a_model_axis():
    cfg = TC.smoke_config("llama3-8b")
    tp = TLM.lm_init(cfg, device="cpu")
    b = {"tokens": torch.zeros((1, 4), dtype=torch.int64), "labels": torch.zeros((1, 4), dtype=torch.int64)}
    mesh = _DataOnlyMesh()
    for call in (lambda: TLM.train_loss(tp, cfg, b, mesh=mesh), lambda: TLM.prefill(tp, cfg, b, mesh=mesh),
                 lambda: TLM.decode_step(tp, cfg, TLM.init_cache(cfg, 1, 8, device="cpu"), b["tokens"][:, :1], 0,
                                         mesh=mesh, seq_shard_axis="data")):
        with pytest.raises(ValueError, match="'model' axis"):
            call()


def test_init_cache_matches_the_reference():
    for arch in ("gemma3-12b", "jamba-v0.1-52b", "qwen2-vl-2b"):
        cj = JLM.init_cache(JC.smoke_config(arch), 2, 24, jnp.float32)
        ct = TLM.init_cache(TC.smoke_config(arch), 2, 24, torch.float32, "cpu")
        close_tree(ct, cj, arch)
        assert [type(v).__name__ for v in ct.values()] == [type(v).__name__ for v in cj.values()]
    assert JS.SSMCache._fields == TS.SSMCache._fields and JLM.AttnCache._fields == TLM.AttnCache._fields
