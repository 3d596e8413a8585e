"""The paper's GAN workloads (Table I), with layer dims from the source
models: DCGAN [4], ArtGAN [5], DiscoGAN [6], GP-GAN [7]."""
import dataclasses

from ..core.tdc import DeconvDims

from .base import ConvSpec, DeconvSpec, GANConfig

K5 = DeconvDims(5, 2, 2, 1)  # DCGAN: K_D=5, S=2 -> K_C=3, C=49
K4 = DeconvDims(4, 2, 1, 0)  # ArtGAN/DiscoGAN/GP-GAN: K_D=4, S=2 -> K_C=2, C=36
K3 = DeconvDims(3, 1, 1, 0)  # ArtGAN last layer: K_D=3, S=1 -> K_C=3, C=16

DCGAN = GANConfig(
    arch_id="dcgan",
    z_dim=100,
    seed_hw=4,
    stem_ch=1024,
    deconvs=(
        DeconvSpec(1024, 512, K5),
        DeconvSpec(512, 256, K5),
        DeconvSpec(256, 128, K5),
        DeconvSpec(128, 3, K5, norm="none", act="tanh"),
    ),
    img_hw=64,
)

ARTGAN = GANConfig(
    arch_id="artgan",
    z_dim=100,
    seed_hw=4,
    stem_ch=512,
    deconvs=(
        DeconvSpec(512, 256, K4),
        DeconvSpec(256, 128, K4),
        DeconvSpec(128, 64, K4),
        DeconvSpec(64, 64, K4),
        DeconvSpec(64, 3, K3, norm="none", act="tanh"),  # the K3/S1 layer of Table I
    ),
    img_hw=64,
)

DISCOGAN = GANConfig(
    arch_id="discogan",
    z_dim=0,  # image-to-image
    seed_hw=4,
    stem_ch=0,
    encoder=(
        ConvSpec(3, 64, 4, 2, norm="none"),
        ConvSpec(64, 128, 4, 2),
        ConvSpec(128, 256, 4, 2),
        ConvSpec(256, 512, 4, 2),
        ConvSpec(512, 512, 4, 1),  # 5th conv (Table I: 5 Conv)
    ),
    deconvs=(
        DeconvSpec(512, 256, K4),
        DeconvSpec(256, 128, K4),
        DeconvSpec(128, 64, K4),
        DeconvSpec(64, 3, K4, norm="none", act="tanh"),
    ),
    img_hw=64,
)

GPGAN = GANConfig(
    arch_id="gpgan",
    z_dim=0,
    seed_hw=4,
    stem_ch=0,
    encoder=(
        ConvSpec(3, 64, 4, 2, norm="none"),
        ConvSpec(64, 128, 4, 2),
        ConvSpec(128, 256, 4, 2),
        ConvSpec(256, 512, 4, 2),
    ),
    deconvs=(
        DeconvSpec(512, 256, K4),
        DeconvSpec(256, 128, K4),
        DeconvSpec(128, 64, K4),
        DeconvSpec(64, 3, K4, norm="none", act="tanh"),
    ),
    img_hw=64,
)

GANS = {c.arch_id: c for c in (DCGAN, ARTGAN, DISCOGAN, GPGAN)}


def tiny_dcgan(deconv_impl: str = "ref", conv_impl: str = "lax") -> GANConfig:
    """DCGAN shrunk to test/smoke scale (16ch stem, 8ch trunk): the one
    config the prepacked/sharded parity tests and the sharded train-step
    benchmark all measure, so they can't drift apart."""
    return dataclasses.replace(
        DCGAN,
        stem_ch=16,
        deconvs=tuple(
            dataclasses.replace(d, c_in=16 if i == 0 else 8, c_out=8 if i < 3 else 3)
            for i, d in enumerate(DCGAN.deconvs)
        ),
        deconv_impl=deconv_impl,
        conv_impl=conv_impl,
        disc_channels=(8, 8, 8, 8),
    )
