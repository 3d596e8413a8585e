"""qwen2-vl-2b [arXiv:2409.12191]: M-RoPE (t,h,w sections 16/24/24),
vision frontend stubbed as precomputed patch embeddings."""
from .base import LMConfig

__all__ = ["CONFIG"]

CONFIG = LMConfig(
    arch_id="qwen2-vl-2b",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936,
    mrope_sections=(16, 24, 24),
    frontend="stub_embeds",
    mlp="swiglu", norm="rmsnorm", family="vlm", subquadratic=False,
)
