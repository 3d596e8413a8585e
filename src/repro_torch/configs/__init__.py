"""The paper's GAN workloads, and the audio decoder stack."""
from .base import ConvSpec, Deconv1dSpec, DeconvSpec, GANConfig
from .gan_zoo import ARTGAN, DCGAN, DISCOGAN, GANS, GPGAN, tiny_dcgan
from .musicgen_medium import audio_decoder

__all__ = ["ConvSpec", "DeconvSpec", "Deconv1dSpec", "GANConfig", "DCGAN", "ARTGAN", "DISCOGAN", "GPGAN", "GANS",
           "tiny_dcgan", "audio_decoder"]
