"""GAN config dataclasses (the GAN part of the reference's configs/base.py)."""
from __future__ import annotations

import dataclasses
from typing import Literal

from ..core.tdc import DeconvDims

__all__ = ["DeconvSpec", "ConvSpec", "GANConfig"]


@dataclasses.dataclass(frozen=True)
class DeconvSpec:
    c_in: int
    c_out: int
    dims: DeconvDims
    norm: str = "batch"  # batch | none
    act: str = "relu"


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    c_in: int
    c_out: int
    kernel: int
    stride: int
    norm: str = "batch"
    act: str = "leaky_relu"


@dataclasses.dataclass(frozen=True)
class GANConfig:
    arch_id: str
    kind: Literal["gan"] = "gan"
    z_dim: int = 100
    seed_hw: int = 4  # spatial size after the stem projection
    stem_ch: int = 1024
    encoder: tuple[ConvSpec, ...] = ()  # image-to-image models (DiscoGAN, GP-GAN)
    deconvs: tuple[DeconvSpec, ...] = ()
    img_ch: int = 3
    img_hw: int = 64
    # generator deconv impl (models.gan.IMPLS): chained ("cuda_chained",
    # "chained_ref") or per layer ("cuda_prepacked", "cuda_fused_pre_prepacked",
    # "prepacked_ref"; raw "cuda", "cuda_fused_pre", "ref"; the baselines
    # "tdc", "zero_padded", "lax").  "cuda*" take the CUDA kernels for CUDA
    # tensors and their plain versions for CPU tensors.  The reference's
    # names are mapped by models.gan.serve_impl.
    deconv_impl: str = "ref"
    # discriminator conv impl (models.gan.CONV_IMPLS): "lax" (PyTorch's own
    # convolution, as the reference leaves it to XLA), or the Winograd conv
    # engine chained ("cuda_chained", "chained_ref") or per layer
    # ("cuda_prepacked", "prepacked_ref"; raw "cuda", "ref")
    conv_impl: str = "lax"
    disc_channels: tuple[int, ...] = (64, 128, 256, 512)

    @property
    def n_deconv(self) -> int:
        return len(self.deconvs)
