"""starcoder2-15b [arXiv:2402.19173]: GQA 12:1, RoPE, GELU MLP, LayerNorm."""
from .base import LMConfig

__all__ = ["CONFIG"]

CONFIG = LMConfig(
    arch_id="starcoder2-15b",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152,
    mlp="gelu", norm="layernorm", family="dense", subquadratic=False,
)
