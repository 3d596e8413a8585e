"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E]:
MoE 16 experts top-1 every layer."""
from .base import LMConfig, MoESpec

__all__ = ["CONFIG"]

CONFIG = LMConfig(
    arch_id="llama4-scout-17b-a16e",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    moe=MoESpec(num_experts=16, top_k=1, every=1),
    mlp="swiglu", norm="rmsnorm", family="moe", subquadratic=False,
)
