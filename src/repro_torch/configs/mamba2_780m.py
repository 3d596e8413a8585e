"""mamba2-780m [arXiv:2405.21060]: attention-free SSD, 48 mamba blocks,
no MLPs (d_ff=0), ssm_state=128."""
from .base import LMConfig, SSMSpec

__all__ = ["CONFIG"]

CONFIG = LMConfig(
    arch_id="mamba2-780m",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    layer_cycle=("mamba",),
    ssm=SSMSpec(d_state=128, d_conv=4, expand=2, head_dim=64),
    norm="rmsnorm", family="ssm", subquadratic=True,
)
