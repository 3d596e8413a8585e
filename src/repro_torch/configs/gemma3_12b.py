"""gemma3-12b [hf:google/gemma-3]: 5 local(SWA 1024):1 global, GeGLU,
huge vocab (262144), tied embeddings."""
from .base import LMConfig

__all__ = ["CONFIG"]

CONFIG = LMConfig(
    arch_id="gemma3-12b",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab=262144,
    attn_cycle=("local",) * 5 + ("global",), window=1024,
    mlp="geglu", norm="rmsnorm", tie_embeddings=True,
    family="dense", subquadratic=True,  # local:global -> eligible long_500k
)
