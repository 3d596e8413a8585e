"""mixtral-8x22b [arXiv:2401.04088]: MoE 8e top-2 every layer, SWA 4096."""
from .base import LMConfig, MoESpec

__all__ = ["CONFIG"]

CONFIG = LMConfig(
    arch_id="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768,
    attn_cycle=("local",), window=4096,
    moe=MoESpec(num_experts=8, top_k=2, every=1),
    mlp="swiglu", norm="rmsnorm", family="moe", subquadratic=True,  # SWA
)
