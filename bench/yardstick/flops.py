"""Model FLOPs of the direct algorithm, from a configuration's shapes.

2 x the multiply-adds that the plain transposed and strided convolutions
and the two matrix products (the stem, the discriminator's head) need:
nothing of the Winograd form, so a better algorithm shows as a gain.  The
train step counts what its two gradient pulls need and nothing more: the
generator's loss through the discriminator to the images and on through
the generator (no gradient of the latents), the discriminator's loss to
its own weights over the fake and the real pass (no gradient of the
images).  ``tests/test_bench_yardstick.py`` holds both counts to
``torch.utils.flop_counter.FlopCounterMode`` over ``reference.gan``.
"""
from __future__ import annotations

from ..reference import gan as R


def _macs(cfg: dict) -> tuple[int, list[int], list[int], int]:
    """Per image: (stem, [each deconv], [each conv], head) multiply-adds."""
    stem = cfg["z_dim"] * cfg["seed_hw"] ** 2 * cfg["stem_ch"]
    g, h = [], cfg["seed_hw"]
    for d, geo in zip(cfg["deconvs"], R.deconv_geos(cfg)):
        g.append(h * h * geo.kernel ** 2 * d["c_in"] * d["c_out"])  # every input pixel meets every tap
        h = geo.out_size(h)
    dmacs, h, chans = [], cfg["img_hw"], [cfg["img_ch"], *cfg["disc_channels"]]
    for j, geo in enumerate(R.conv_geos(cfg)):
        h = geo.out_size(h)
        dmacs.append(h * h * geo.kernel ** 2 * chans[j] * chans[j + 1])
    return stem, g, dmacs, h * h * chans[-1]


def generate_flops(cfg: dict, images: int) -> int:
    """FLOPs of generating ``images`` images (eval mode)."""
    stem, g, _, _ = _macs(cfg)
    return 2 * images * (stem + sum(g))


def train_step_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one train step at ``batch``: the forward (G, D on the fake
    and on the real batch), the G pull (D's input gradients, G's input and
    weight gradients, the stem's weight gradient) and the D pull (D's
    weight gradients over both passes, its input gradients above the first
    conv)."""
    stem, g, d, head = _macs(cfg)
    sg, sd = sum(g), sum(d) + head
    forward = stem + sg + 2 * sd
    g_pull = sd + 2 * sg + stem
    d_pull = 2 * (sd + sd - d[0])
    return 2 * batch * (forward + g_pull + d_pull)
