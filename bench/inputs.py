"""What the benchmark hands both the program and the reference, made from
the seed: raw weights, batchnorm affines and running statistics, drawn on
the device in a few large calls."""
from __future__ import annotations

import torch

from .reference import gan as R

_MASK = (1 << 63) - 1


def stream_seed(seed: int, stream: int) -> int:
    """A seed of its own for each of a run's random streams."""
    return (seed * 1_000_003 + stream) & _MASK


def param_shapes(cfg: dict) -> tuple[dict, dict]:
    """(generator, discriminator) leaf -> (shape, how it is drawn); the
    port's param keys, joined by dots."""
    g: dict = {}
    f = cfg["seed_hw"] ** 2 * cfg["stem_ch"]
    g["stem.w"] = ((cfg["z_dim"], f), ("normal", cfg["z_dim"] ** -0.5, 0.0))
    g["stem.b"] = ((f,), ("normal", 0.1, 0.0))
    bn = lambda c: {"scale": ((c,), ("normal", 0.1, 1.0)), "bias": ((c,), ("normal", 0.1, 0.0)),  # noqa: E731
                    "mean": ((c,), ("normal", 0.1, 0.0)), "var": ((c,), ("uniform", 0.5, 1.0))}
    g.update({f"stem_bn.{k}": v for k, v in bn(cfg["stem_ch"]).items()})
    for i, d in enumerate(cfg["deconvs"]):
        g[f"deconv{i}.w"] = ((d["kernel"], d["kernel"], d["c_in"], d["c_out"]), ("normal", 0.02, 0.0))
        if d["norm"] == "batch":
            g.update({f"deconv{i}_bn.{k}": v for k, v in bn(d["c_out"]).items()})
    dsc: dict = {}
    chans = [cfg["img_ch"], *cfg["disc_channels"]]
    k = cfg["disc_kernel"]
    for j in range(len(chans) - 1):
        dsc[f"conv{j}.w"] = ((k, k, chans[j], chans[j + 1]), ("normal", (k * k * chans[j]) ** -0.5, 0.0))
        dsc[f"conv{j}.b"] = ((chans[j + 1],), ("normal", 0.01, 0.0))
        if j > 0:
            dsc.update({f"conv{j}_bn.{kk}": v for kk, v in bn(chans[j + 1]).items()})
    hw = cfg["img_hw"]
    for _ in R.conv_geos(cfg):
        hw = -(-hw // cfg["disc_stride"])
    dsc["head.w"] = ((hw * hw * chans[-1], 1), ("normal", (hw * hw * chans[-1]) ** -0.5, 0.0))
    dsc["head.b"] = ((1,), ("normal", 0.1, 0.0))
    return g, dsc


def draw_params(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """Raw generator and discriminator trees (flat, float32) on ``device``:
    one normal and one uniform draw for all the leaves, then cut and scaled
    (``normal``: loc + scale N(0, 1); ``uniform``: loc + scale U(-1, 1))."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    trees = param_shapes(cfg)
    sizes = {kind: sum(int(torch.Size(s).numel()) for t in trees for s, (k, _, _) in t.values() if k == kind)
             for kind in ("normal", "uniform")}
    pool = {"normal": torch.randn(sizes["normal"], generator=gen, device=device),
            "uniform": torch.rand(sizes["uniform"], generator=gen, device=device) * 2 - 1}
    at = {"normal": 0, "uniform": 0}
    out = []
    for tree in trees:
        leaves = {}
        for name, (shape, (kind, scale, loc)) in tree.items():
            n = int(torch.Size(shape).numel())
            leaves[name] = (pool[kind][at[kind] : at[kind] + n] * scale + loc).reshape(shape)
            at[kind] += n
        out.append(leaves)
    return out[0], out[1]


def nest(flat: dict) -> dict:
    """{"stem.w": t} -> {"stem": {"w": t}}: the port's param trees."""
    out: dict = {}
    for key, v in flat.items():
        layer, leaf = key.split(".")
        out.setdefault(layer, {})[leaf] = v
    return out


def flatten(tree: dict) -> dict:
    """The inverse of ``nest``."""
    return {f"{layer}.{leaf}": v for layer, leaves in tree.items() for leaf, v in leaves.items()}
