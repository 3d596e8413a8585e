"""llama3-8b [arXiv:2407.21783]: GQA 4:1, RoPE 500k theta, SwiGLU."""
from .base import LMConfig

__all__ = ["CONFIG"]

CONFIG = LMConfig(
    arch_id="llama3-8b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, rope_theta=500000.0,
    mlp="swiglu", norm="rmsnorm", family="dense", subquadratic=False,
)
