"""Deterministic synthetic data (the reference's ``data`` package)."""
from .synthetic import embed_batch, gan_batch, latent_batch, lm_batch

__all__ = ["latent_batch", "gan_batch", "lm_batch", "embed_batch"]
