"""The GAN of a benchmark configuration in plain PyTorch: generator,
discriminator, their losses and the AdamW training step, in float32.

Two forms of one function.  ``packed=False`` runs the convolutions as
``F.conv_transpose2d`` / ``F.conv2d`` on raw (K, K, N, M) weights: the
served generator, and the count of the direct algorithm's FLOPs.
``packed=True`` runs them in the Winograd domain on packed (C, N, M)
weights (``winograd.deconv`` / ``winograd.conv``), which is what the port
trains: its AdamW moves the packed leaves.  On raw weights packed by
``pack_params`` both forms compute the same function.

``tf32=True`` rounds the operands of every product (matrix products,
Winograd-domain contractions and convolutions) to TF32: the control, one
precision below the configuration's float32.  Nothing here reads a setting
of the device; the caller turns the device's own TF32 off
(``fp32_products``).

Parameter trees are flat dicts keyed "layer.leaf" (``stem.w``,
``deconv0_bn.mean``, ...), the port's nested keys joined by dots.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from . import winograd as W


@contextlib.contextmanager
def fp32_products():
    """TF32 off for matrix products and cuDNN convolutions inside the
    context, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def deconv_geos(cfg: dict) -> list[W.Deconv]:
    return [W.Deconv(d["kernel"], d["stride"], d["padding"], d["output_padding"]) for d in cfg["deconvs"]]


def conv_geos(cfg: dict) -> list[W.Conv]:
    h, out = cfg["img_hw"], []
    for _ in cfg["disc_channels"]:
        out.append(W.Conv.same(cfg["disc_kernel"], cfg["disc_stride"], h))
        h = out[-1].out_size(h)
    return out


def pack_params(gp: dict, dp: dict, cfg: dict) -> tuple[dict, dict]:
    """Raw trees -> the trees the port trains: every deconv and conv weight
    packed into the Winograd domain (``winograd.pack``)."""
    gp, dp = dict(gp), dict(dp)
    for i, geo in enumerate(deconv_geos(cfg)):
        gp[f"deconv{i}.ww"] = W.pack(gp.pop(f"deconv{i}.w"), geo)
    for i, geo in enumerate(conv_geos(cfg)):
        dp[f"conv{i}.ww"] = W.pack(dp.pop(f"conv{i}.w"), geo)
    return gp, dp


def _act(name: str, x: torch.Tensor, slope: float) -> torch.Tensor:
    if name == "relu":
        return torch.relu(x)
    if name == "tanh":
        return torch.tanh(x)
    if name == "leaky_relu":
        return torch.where(x >= 0, x, slope * x)
    if name == "none":
        return x
    raise ValueError(f"unknown activation {name!r}")


def _bn(p: dict, name: str, x: torch.Tensor, cfg: dict, training: bool, stats: dict) -> torch.Tensor:
    """NHWC batchnorm: batch mean and population variance in training
    (the running statistics move by the momentum, into ``stats``), the
    running statistics in eval."""
    eps, mom = cfg["bn_eps"], cfg["bn_momentum"]
    if training:
        mu = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), unbiased=False)
        stats[f"{name}.mean"] = mom * p[f"{name}.mean"] + (1 - mom) * mu.detach()
        stats[f"{name}.var"] = mom * p[f"{name}.var"] + (1 - mom) * var.detach()
    else:
        mu, var = p[f"{name}.mean"], p[f"{name}.var"]
    return (x - mu) * torch.rsqrt(var + eps) * p[f"{name}.scale"] + p[f"{name}.bias"]


def _linear(p: dict, name: str, x: torch.Tensor, op) -> torch.Tensor:
    return op(x) @ op(p[f"{name}.w"]) + p[f"{name}.b"]


def generator(p: dict, cfg: dict, z: torch.Tensor, *, training: bool, packed: bool, tf32: bool = False):
    """Latents (B, z_dim) -> (NHWC images, moved running statistics)."""
    op = W.product_operands(tf32)
    stats: dict = {}
    h = _linear(p, "stem", z, op).reshape(z.shape[0], cfg["seed_hw"], cfg["seed_hw"], cfg["stem_ch"])
    h = torch.relu(_bn(p, "stem_bn", h, cfg, training, stats))
    for i, (d, geo) in enumerate(zip(cfg["deconvs"], deconv_geos(cfg))):
        if packed:
            h = W.deconv(h, p[f"deconv{i}.ww"], geo, tf32=tf32)
        else:
            h = F.conv_transpose2d(op(h).permute(0, 3, 1, 2), op(p[f"deconv{i}.w"]).permute(2, 3, 0, 1),
                                   stride=geo.stride, padding=geo.padding,
                                   output_padding=geo.output_padding).permute(0, 2, 3, 1)
        if d["norm"] == "batch":
            h = _bn(p, f"deconv{i}_bn", h, cfg, training, stats)
        h = _act(d["act"], h, cfg["leaky_slope"])
    return h, stats


def discriminator(p: dict, cfg: dict, img: torch.Tensor, *, training: bool, packed: bool, tf32: bool = False):
    """NHWC images -> (logits (B, 1), moved running statistics): K4S2 "SAME"
    convs with their bias, batchnorm after every conv but the first,
    leaky_relu, a linear head."""
    op = W.product_operands(tf32)
    stats: dict = {}
    h = img
    for i, geo in enumerate(conv_geos(cfg)):
        if packed:
            h = W.conv(h, p[f"conv{i}.ww"], geo, tf32=tf32)
        else:
            xc = F.pad(op(h).permute(0, 3, 1, 2), (geo.padding, geo.pad_hi, geo.padding, geo.pad_hi))
            h = F.conv2d(xc, op(p[f"conv{i}.w"]).permute(3, 2, 0, 1), stride=geo.stride).permute(0, 2, 3, 1)
        h = h + p[f"conv{i}.b"]
        if f"conv{i}_bn.scale" in p:
            h = _bn(p, f"conv{i}_bn", h, cfg, training, stats)
        h = _act("leaky_relu", h, cfg["leaky_slope"])
    return _linear(p, "head", h.reshape(h.shape[0], -1), op), stats


def _bce(logit: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean(torch.clamp_min(logit, 0) - logit * target + torch.log1p(torch.exp(-logit.abs())))


def losses(gp, dp, cfg, z, real, *, packed: bool, tf32: bool = False):
    """(g_loss, d_loss, g_stats, d_stats): the non-saturating generator loss
    and the discriminator's, from one generator forward; the
    discriminator's statistics are those of its pass over the real batch."""
    fake, g_stats = generator(gp, cfg, z, training=True, packed=packed, tf32=tf32)
    d_fake, _ = discriminator(dp, cfg, fake, training=True, packed=packed, tf32=tf32)
    d_real, d_stats = discriminator(dp, cfg, real, training=True, packed=packed, tf32=tf32)
    g_loss = _bce(d_fake, 1.0)
    d_loss = 0.5 * (_bce(d_real, 1.0) + _bce(d_fake, 0.0))
    return g_loss, d_loss, g_stats, d_stats


def is_running_stat(name: str) -> bool:
    return name.endswith(".mean") or name.endswith(".var")


def adam_init(p: dict) -> dict:
    return {"t": 0, "m": {k: torch.zeros_like(v) for k, v in p.items()},
            "v": {k: torch.zeros_like(v) for k, v in p.items()}}


def adam(p: dict, grads: dict, st: dict, *, lr: float, b1: float, b2: float = 0.999, eps: float = 1e-8):
    """AdamW without weight decay (Kingma and Ba's Algorithm 1, bias
    corrected): returns (new params, new state)."""
    t = st["t"] + 1
    new_p, m, v = {}, {}, {}
    for k, x in p.items():
        g = grads[k]
        m[k] = b1 * st["m"][k] + (1 - b1) * g
        v[k] = b2 * st["v"][k] + (1 - b2) * g * g
        new_p[k] = adam_apply(x, m[k], v[k], t, lr=lr, b1=b1, b2=b2, eps=eps)
    return new_p, {"t": t, "m": m, "v": v}


def adam_apply(x, m, v, t: int, *, lr: float, b1: float, b2: float = 0.999, eps: float = 1e-8):
    """A leaf ``x`` after AdamW's step ``t``, from the moments ``m``, ``v``
    that step left."""
    return x - lr * (m / (1 - b1**t)) / (torch.sqrt(v / (1 - b2**t)) + eps)


def train_step(gp, dp, g_opt, d_opt, z, real, cfg, *, lr: float, b1: float, packed: bool = True,
               tf32: bool = False):
    """One simultaneous G / D step: both losses from one forward, the
    generator's gradient, then the discriminator's, an AdamW step on each
    side, the moved running statistics merged.  Running statistics get a
    zero gradient.  Returns (gp, dp, g_opt, d_opt, g_loss, d_loss, g_grads,
    d_grads)."""
    gp_ = {k: v.detach().requires_grad_(not is_running_stat(k)) for k, v in gp.items()}
    dp_ = {k: v.detach().requires_grad_(not is_running_stat(k)) for k, v in dp.items()}
    with torch.enable_grad():
        g_loss, d_loss, g_stats, d_stats = losses(gp_, dp_, cfg, z, real, packed=packed, tf32=tf32)
        gg = _grads(g_loss, gp_, retain_graph=True)
        dg = _grads(d_loss, dp_, retain_graph=False)
    gp2, g_opt = adam({k: v.detach() for k, v in gp_.items()}, gg, g_opt, lr=lr, b1=b1)
    dp2, d_opt = adam({k: v.detach() for k, v in dp_.items()}, dg, d_opt, lr=lr, b1=b1)
    gp2.update(g_stats)
    dp2.update(d_stats)
    return gp2, dp2, g_opt, d_opt, g_loss.detach(), d_loss.detach(), gg, dg


def _grads(loss, tree: dict, *, retain_graph: bool) -> dict:
    keys = [k for k, v in tree.items() if v.requires_grad]
    got = torch.autograd.grad(loss, [tree[k] for k in keys], retain_graph=retain_graph, allow_unused=True)
    out = {k: torch.zeros_like(v) for k, v in tree.items()}
    out.update({k: g if g is not None else torch.zeros_like(tree[k]) for k, g in zip(keys, got)})
    return out
