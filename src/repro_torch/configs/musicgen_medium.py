"""musicgen-medium [arXiv:2306.05284]: decoder-only over EnCodec tokens
(vocab 2048); the EnCodec codec frontend is a stub, token ids in.  Also the
MusicGen-style audio decoder stack (``audio_decoder``), as in the
reference's ``configs/musicgen_medium.py``."""
from __future__ import annotations

from ..core.tdc import DeconvDims
from .base import Deconv1dSpec, LMConfig

__all__ = ["CONFIG", "audio_decoder"]

CONFIG = LMConfig(
    arch_id="musicgen-medium",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048,
    mlp="gelu", norm="layernorm", family="audio", subquadratic=False,
)


def audio_decoder(width: int = 64) -> tuple[Deconv1dSpec, ...]:
    """EnCodec-style 1D deconv decoder: three K4S2 upsampling layers (each
    doubles the sequence length), latent -> waveform, channels 4w -> 2w ->
    w -> 1.  Every layer is the 1D engine's K4S2 TDC geometry: per
    sub-filter C(2) = 3 of n = 4 positions, a 2x interleave in the
    finalize.  ``width`` scales the channel counts (tests shrink it)."""
    k4s2 = DeconvDims(kernel=4, stride=2, padding=1)
    return (
        Deconv1dSpec(width * 4, width * 2, k4s2, act="relu"),
        Deconv1dSpec(width * 2, width, k4s2, act="relu"),
        Deconv1dSpec(width, 1, k4s2, act="tanh"),
    )
