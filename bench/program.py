"""The system under test, as the benchmark reaches it: the port's GAN
configuration for a benchmark configuration file, checked against the
port's own, and the kernel names its profiler records carry."""
from __future__ import annotations

import dataclasses

# the port's kernel families, by the wrapper that launches them (the names
# its CUDA sources give; a template instantiation or not)
KERNELS = {
    "fused_engine": ("fused_epi_kernel", "fused_epi_mma_kernel"),
    "fused_engine_bwd_x": ("bwd_x_kernel", "bwd_x_mma_kernel"),
    "fused_engine_bwd_w": ("bwd_w_kernel", "bwd_w_mma_kernel"),
    "conv_fused_engine": ("conv_fwd_kernel", "conv_fwd_mma_kernel"),
    "conv_fused_engine_bwd_x": ("conv_bwd_x_kernel", "conv_bwd_x_mma_kernel"),
    "conv_fused_engine_bwd_w": ("conv_bwd_w_kernel", "conv_bwd_w_mma_kernel"),
}


def family_of(kernel_name: str):
    """The wrapper whose kernel the profiler's ``kernel_name`` is, or None.
    The port's kernels sit in an anonymous namespace
    (``void (anonymous namespace)::bwd_x_mma_kernel<...>(...)``), so a
    family matches on ``::name<`` or ``::name(`` and never on a name that
    merely contains another (``conv_bwd_x_kernel`` is not ``bwd_x_kernel``)."""
    for fam, names in KERNELS.items():
        if any(f"::{n}<" in kernel_name or f"::{n}(" in kernel_name for n in names):
            return fam
    return None


def gan_config(cfg: dict, *, deconv_impl: str, conv_impl: str = "lax"):
    """The port's ``GANConfig`` for a benchmark configuration.  The file
    states every width itself; where it names one of the port's configs
    (``port_config``), the two must agree, or the run stops."""
    from repro_torch.configs import base, gan_zoo
    from repro_torch.core.tdc import DeconvDims

    deconvs = tuple(base.DeconvSpec(d["c_in"], d["c_out"],
                                    DeconvDims(d["kernel"], d["stride"], d["padding"], d["output_padding"]),
                                    norm=d["norm"], act=d["act"]) for d in cfg["deconvs"])
    mine = base.GANConfig(arch_id=cfg["name"], z_dim=cfg["z_dim"], seed_hw=cfg["seed_hw"], stem_ch=cfg["stem_ch"],
                          deconvs=deconvs, img_ch=cfg["img_ch"], img_hw=cfg["img_hw"],
                          disc_channels=tuple(cfg["disc_channels"]), deconv_impl=deconv_impl, conv_impl=conv_impl)
    if cfg.get("port_config"):
        theirs = dataclasses.replace(getattr(gan_zoo, cfg["port_config"]), deconv_impl=deconv_impl,
                                     conv_impl=conv_impl)
        if theirs != mine:
            raise SystemExit(f"bench: configuration {cfg['name']!r} differs from the port's "
                             f"{cfg['port_config']}: {mine} != {theirs}")
    return mine
