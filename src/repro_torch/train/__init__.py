"""Training (the reference's ``train`` package): the single-device GAN step."""
from .trainer import METRIC_SPEC_KEYS, StepSettings, gan_losses, make_gan_step, nonfinite_flag

__all__ = ["METRIC_SPEC_KEYS", "StepSettings", "gan_losses", "make_gan_step", "nonfinite_flag"]
