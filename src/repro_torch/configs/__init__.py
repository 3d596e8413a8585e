"""Architecture registry: the paper's GAN workloads, the audio decoder
stack, and the ten LM configs (the reference's ``configs/__init__.py``):
``get_config(arch_id)``, ``list_archs``, ``smoke_config`` and the shape
registry."""
from __future__ import annotations

import dataclasses

from . import (
    gemma3_12b,
    jamba_v0_1_52b,
    llama3_8b,
    llama4_scout_17b_a16e,
    mamba2_780m,
    mixtral_8x22b,
    musicgen_medium,
    phi3_mini_3_8b,
    qwen2_vl_2b,
    starcoder2_15b,
)
from .base import (SHAPES, ConvSpec, Deconv1dSpec, DeconvSpec, GANConfig, LMConfig, MoESpec, ShapeConfig, SSMSpec,
                   shape_applicable)
from .gan_zoo import ARTGAN, DCGAN, DISCOGAN, GANS, GPGAN, tiny_dcgan
from .musicgen_medium import audio_decoder

__all__ = ["ConvSpec", "DeconvSpec", "Deconv1dSpec", "GANConfig", "DCGAN", "ARTGAN", "DISCOGAN", "GPGAN", "GANS",
           "tiny_dcgan", "audio_decoder", "LMConfig", "MoESpec", "SSMSpec", "ShapeConfig", "SHAPES",
           "shape_applicable", "LMS", "REGISTRY", "get_config", "list_archs", "smoke_config"]

LMS = {
    m.CONFIG.arch_id: m.CONFIG
    for m in (
        phi3_mini_3_8b,
        starcoder2_15b,
        gemma3_12b,
        llama3_8b,
        musicgen_medium,
        jamba_v0_1_52b,
        llama4_scout_17b_a16e,
        mixtral_8x22b,
        mamba2_780m,
        qwen2_vl_2b,
    )
}

REGISTRY: dict[str, object] = {**LMS, **GANS}


def get_config(arch_id: str):
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def list_archs() -> list[str]:
    return sorted(REGISTRY)


def smoke_config(arch_id: str) -> LMConfig:
    """Reduced same-family config for CPU smoke tests: few layers (one full
    super-block period, twice), narrow width, tiny vocab, few experts kept
    >= top_k."""
    cfg = LMS[arch_id]
    from ..models.lm import superblock_period  # lazily, as the reference

    period = superblock_period(cfg)
    moe = dataclasses.replace(cfg.moe, num_experts=max(4, cfg.moe.top_k * 2)) if cfg.moe else None
    ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=8, chunk=8) if cfg.ssm else None
    hd = 16
    return dataclasses.replace(
        cfg,
        n_layers=period * 2,
        d_model=64,
        n_heads=max(4, cfg.n_heads and 4),
        n_kv_heads=2 if cfg.n_kv_heads else 0,
        head_dim=hd if cfg.n_heads else None,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        window=8 if cfg.window else 0,
        moe=moe,
        ssm=ssm,
        mrope_sections=(4, 2, 2) if cfg.mrope_sections else None,
    )
