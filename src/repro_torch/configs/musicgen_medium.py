"""The MusicGen-style audio decoder stack (the reference's
``configs/musicgen_medium.py::audio_decoder``).

The reference's module also holds ``CONFIG``, musicgen-medium's decoder-only
LM over EnCodec tokens (an ``LMConfig``).  The port has no LM stack yet, so
only the waveform head is here; ``CONFIG`` comes with the LM slice."""
from __future__ import annotations

from ..core.tdc import DeconvDims
from .base import Deconv1dSpec

__all__ = ["audio_decoder"]


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
