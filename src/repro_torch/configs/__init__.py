"""The paper's GAN workloads."""
from .base import ConvSpec, DeconvSpec, GANConfig
from .gan_zoo import ARTGAN, DCGAN, DISCOGAN, GANS, GPGAN, tiny_dcgan

__all__ = ["ConvSpec", "DeconvSpec", "GANConfig", "DCGAN", "ARTGAN", "DISCOGAN", "GPGAN", "GANS",
           "tiny_dcgan"]
