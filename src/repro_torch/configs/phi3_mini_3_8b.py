"""phi3-mini-3.8b [arXiv:2404.14219]: dense, RoPE, SwiGLU, MHA (kv=heads)."""
from .base import LMConfig

__all__ = ["CONFIG"]

CONFIG = LMConfig(
    arch_id="phi3-mini-3.8b",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064,
    mlp="swiglu", norm="rmsnorm", family="dense", subquadratic=False,
)
