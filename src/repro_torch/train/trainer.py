"""The adversarial GAN train step on one device (the reference's
``train/trainer.py::make_gan_step`` without a mesh).

One shared forward of ``gan_losses`` gives both objectives; two
``torch.autograd.grad`` pulls on that one graph give the generator's
gradients (``retain_graph=True``) and then the discriminator's.  The D pull
asks only for the discriminator's leaves, so autograd never runs the
generator's backward for it.  Each side then takes an AdamW step and its
moved batchnorm statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..configs.base import GANConfig
from ..models import gan as G
from ..optim import adamw_update
from ..tree import tree_leaves, tree_map

__all__ = ["METRIC_SPEC_KEYS", "StepSettings", "nonfinite_flag", "gan_losses", "make_gan_step"]

#: every step emits these
METRIC_SPEC_KEYS = ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm", "nonfinite")
#: the metrics the non-finite sentinel watches
METRIC_KEYS = METRIC_SPEC_KEYS[:4]


@dataclasses.dataclass(frozen=True)
class StepSettings:
    """How a GAN train step is built.

    Fields:
      lr, b1            AdamW learning rate / beta1
      deconv_impl       generator backend override (None = cfg's)
      conv_impl         discriminator backend override (None = cfg's)
      mesh, overlap, grad_compression, bucket_bytes
                        the reference's multi-device step; not in the port
                        yet, and refused when set
    """

    lr: float = 2e-4
    b1: float = 0.5
    deconv_impl: Optional[str] = None
    conv_impl: Optional[str] = None
    mesh: Any = None
    overlap: bool = False
    grad_compression: Optional[str] = None
    bucket_bytes: Optional[int] = None

    def __post_init__(self):
        multi = {k: getattr(self, k) for k in ("mesh", "overlap", "grad_compression", "bucket_bytes")}
        if any(v not in (None, False) for v in multi.values()):
            raise NotImplementedError(
                f"multi-device step settings {multi} are not in the port yet: the step runs on one device"
            )

    def apply_to_cfg(self, cfg: GANConfig) -> GANConfig:
        """cfg with the impl overrides substituted."""
        if self.deconv_impl is not None:
            cfg = dataclasses.replace(cfg, deconv_impl=self.deconv_impl)
        if self.conv_impl is not None:
            cfg = dataclasses.replace(cfg, conv_impl=self.conv_impl)
        return cfg


def nonfinite_flag(metrics: dict) -> torch.Tensor:
    """1.0 when any watched step metric is non-finite (a NaN loss, an inf
    grad norm), else 0.0: one reduction over four scalars."""
    vals = torch.stack([torch.as_tensor(metrics[k]).float() for k in METRIC_KEYS if k in metrics])
    return (~torch.isfinite(vals).all()).float()


def _bce(logit: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean(torch.clamp_min(logit, 0) - logit * target + torch.log1p(torch.exp(-logit.abs())))


def gan_losses(gp, dp, cfg: GANConfig, z, real, *, training=True):
    """(g_loss, d_loss, (g_stats, d_stats, fake)): the non-saturating
    generator loss and the discriminator loss from one generator forward;
    the discriminator's moved statistics are those of the real pass."""
    fake, g_stats = G.generator_apply(gp, cfg, z, training=training)
    d_fake, _ = G.discriminator_apply(dp, cfg, fake, training=training)
    d_real, d_stats = G.discriminator_apply(dp, cfg, real, training=training)
    g_loss = _bce(d_fake, 1.0)
    d_loss = 0.5 * (_bce(d_real, 1.0) + _bce(d_fake, 0.0))
    return g_loss, d_loss, (g_stats, d_stats, fake)


def _grads(loss, tree, *, retain_graph: bool):
    """d loss / d every leaf of ``tree``, as a tree; leaves the loss does
    not reach (running statistics) get zeros."""
    leaves = tree_leaves(tree)
    gs = torch.autograd.grad(loss, leaves, retain_graph=retain_graph, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs))
    return tree_map(lambda _: next(it), tree)


def make_gan_step(cfg: GANConfig, *, settings: Optional[StepSettings] = None):
    """The GAN train step ``step(gp, dp, g_opt, d_opt, z, real) -> (gp, dp,
    g_opt, d_opt, metrics)``: a simultaneous G/D update from one shared
    forward and two gradient pulls.  Inputs are left as they are; the
    returned trees are new.  ``metrics`` holds 0-d tensors under
    ``METRIC_SPEC_KEYS``."""
    st = settings if settings is not None else StepSettings()
    cfg = st.apply_to_cfg(cfg)
    lr, b1 = st.lr, st.b1

    def step(gp, dp, g_opt, d_opt, z, real):
        gp_ = tree_map(lambda t: t.detach().requires_grad_(True), gp)
        dp_ = tree_map(lambda t: t.detach().requires_grad_(True), dp)
        with torch.enable_grad():
            g_loss, d_loss, (g_stats, d_stats, _) = gan_losses(gp_, dp_, cfg, z, real)
            g_grads = _grads(g_loss, gp_, retain_graph=True)
            d_grads = _grads(d_loss, dp_, retain_graph=False)
        detach = lambda tree: tree_map(torch.Tensor.detach, tree)  # noqa: E731
        gp2, g_opt2, gm = adamw_update(detach(gp_), g_grads, g_opt, lr=lr, b1=b1)
        gp2 = G.merge_bn_stats(gp2, detach(g_stats))
        dp2, d_opt2, dm = adamw_update(detach(dp_), d_grads, d_opt, lr=lr, b1=b1)
        dp2 = G.merge_bn_stats(dp2, detach(d_stats))
        metrics = {
            "g_loss": g_loss.detach(),
            "d_loss": d_loss.detach(),
            "g_grad_norm": gm["grad_norm"],
            "d_grad_norm": dm["grad_norm"],
        }
        metrics["nonfinite"] = nonfinite_flag(metrics)
        return gp2, dp2, g_opt2, d_opt2, metrics

    return step
