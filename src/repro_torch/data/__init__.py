"""Deterministic synthetic data (the reference's ``data`` package)."""
from .synthetic import gan_batch, latent_batch

__all__ = ["latent_batch", "gan_batch"]
