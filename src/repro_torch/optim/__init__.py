"""Optimizers (the reference's ``optim`` package)."""
from .adam import OptState, adamw_init, adamw_update, clip_by_global_norm

__all__ = ["OptState", "adamw_init", "adamw_update", "clip_by_global_norm"]
