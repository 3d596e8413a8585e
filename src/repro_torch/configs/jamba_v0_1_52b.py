"""jamba-v0.1-52b [arXiv:2403.19887]: 1 attn : 7 mamba per period-8 block,
MoE 16e top-2 on every other layer."""
from .base import LMConfig, MoESpec, SSMSpec

__all__ = ["CONFIG"]

CONFIG = LMConfig(
    arch_id="jamba-v0.1-52b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536,
    layer_cycle=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    moe=MoESpec(num_experts=16, top_k=2, every=2),
    ssm=SSMSpec(d_state=16, d_conv=4, expand=2, head_dim=64),
    mlp="swiglu", norm="rmsnorm", family="hybrid", subquadratic=True,
)
