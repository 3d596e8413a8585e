"""Deterministic synthetic GAN data: every batch is a function of
(seed, step), drawn from an explicit ``torch.Generator`` on the target
device, so a restarted run replays the same stream.

The formulas are the reference's ``data/synthetic.py``; the random streams
are PyTorch's, not ``jax.random``'s, so the two packages draw different
numbers from one seed (parity tests feed both the same numpy batches).
"""
from __future__ import annotations

import math

import torch

__all__ = ["latent_batch", "gan_batch"]


def _gen(seed: int, step: int, tag: int, device) -> torch.Generator:
    """A generator for stream ``tag`` of (seed, step): the three integers
    mixed into one 63-bit seed."""
    mixed = ((seed * 1_000_003 + step) * 1_000_033 + tag) % (2**63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)


def latent_batch(seed: int, step: int, batch: int, z_dim: int, *, device="cuda") -> torch.Tensor:
    """(batch, z_dim) standard-normal latents."""
    return torch.randn((batch, z_dim), generator=_gen(seed, step, 0, device), device=device)


def gan_batch(seed: int, step: int, batch: int, hw: int, ch: int = 3, *, device="cuda") -> torch.Tensor:
    """Smooth synthetic 'real' images (batch, hw, hw, ch) in [-1, 1]: random
    low-frequency Fourier modes, cheap and with non-degenerate statistics."""
    g = _gen(seed, step, 1, device)
    n_modes = 6
    kw = dict(generator=g, device=device)
    freq = 0.5 + 2.5 * torch.rand((batch, n_modes, 2, ch), **kw)
    phase = 2 * math.pi * torch.rand((batch, n_modes, 2, ch), **kw)
    amp = torch.randn((batch, n_modes, ch), **kw) / n_modes
    yy = torch.linspace(0, 2 * math.pi, hw, device=device)
    img = torch.zeros((batch, hw, hw, ch), device=device)
    for m in range(n_modes):
        wave_y = torch.sin(freq[:, m, 0, None, :] * yy[None, :, None] + phase[:, m, 0, None, :])
        wave_x = torch.sin(freq[:, m, 1, None, :] * yy[None, :, None] + phase[:, m, 1, None, :])
        img = img + amp[:, m, None, None, :] * wave_y[:, :, None, :] * wave_x[:, None, :, :]
    return torch.tanh(img)
