"""Config dataclasses and the input-shape registry (the reference's
``configs/base.py``): the GAN configs and the audio decoder's layer, the LM
configs (``LMConfig`` with its ``MoESpec`` / ``SSMSpec``), and ``SHAPES``
with ``shape_applicable``."""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

from ..core.tdc import DeconvDims

__all__ = ["DeconvSpec", "Deconv1dSpec", "ConvSpec", "GANConfig", "MoESpec", "SSMSpec", "LMConfig", "ShapeConfig",
           "SHAPES", "shape_applicable"]


@dataclasses.dataclass(frozen=True)
class DeconvSpec:
    c_in: int
    c_out: int
    dims: DeconvDims
    norm: str = "batch"  # batch | none
    act: str = "relu"


@dataclasses.dataclass(frozen=True)
class Deconv1dSpec:
    """One layer of a MusicGen-style audio deconv decoder (1D TDC upsample)."""

    c_in: int
    c_out: int
    dims: DeconvDims  # per-axis scalar geometry, used 1D (K_D, S, P, OP)
    act: str = "relu"  # relu | leaky_relu | tanh | none


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


# -------------------------------------------------------------------- LM
@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    every: int = 1  # MoE on layers where (layer_idx % every) == every-1
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """One LM architecture, field for field the reference's.  The knobs
    that only steer the reference's TPU lowering (``attn_bf16_qk``,
    ``moe_ep``, ``act_hints``, ``ssm_bf16``) are kept so that configs compare
    equal; the port reads ``attn_bf16_qk`` and ``ssm_bf16`` as the
    reference does (the operands rounded as it rounds them, fp32
    accumulation); ``moe_ep`` and ``act_hints`` act only on a mesh (ROADMAP
    item 6d)."""

    arch_id: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    kind: Literal["lm"] = "lm"
    head_dim: Optional[int] = None  # default d_model // n_heads
    # layer-kind cycle, tiled over n_layers: "attn" | "mamba"
    layer_cycle: tuple[str, ...] = ("attn",)
    # attention-kind cycle over *attention* layers: "global" | "local"
    attn_cycle: tuple[str, ...] = ("global",)
    window: int = 0  # sliding-window size for "local" attention (0 = full)
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp: str = "swiglu"  # swiglu | gelu | geglu
    rope_theta: float = 10000.0
    mrope_sections: Optional[tuple[int, int, int]] = None  # qwen2-vl
    frontend: str = "tokens"  # tokens | stub_embeds (audio/vlm backbone-only)
    tie_embeddings: bool = False
    remat: bool = True
    attn_bf16_qk: bool = False  # bf16-operand QK^T, fp32 accumulation and softmax
    moe_ep: bool = False  # expert parallelism over "data" (a mesh only)
    q_chunk: int = 1024
    loss_chunk: int = 512
    act_hints: bool = True  # activation placement hints (a mesh only)
    ssm_bf16: bool = False  # bf16-operand SSD einsums, fp32 accumulation
    # families for shape-skip logic
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm
    subquadratic: bool = False  # eligible for long_500k

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def layer_kinds(self) -> list[str]:
        c = (self.layer_cycle * self.n_layers)[: self.n_layers]
        return list(c)

    def attn_kinds(self) -> list[str]:
        """Kind per layer ('', 'global' or 'local')."""
        kinds, ai = [], 0
        for lk in self.layer_kinds():
            if lk == "attn":
                kinds.append(self.attn_cycle[ai % len(self.attn_cycle)])
                ai += 1
            else:
                kinds.append("")
        return kinds


# ------------------------------------------------------------------ shapes
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-not), the reference's skip rules."""
    if getattr(cfg, "kind", "lm") == "gan":
        return (shape.name == "train_4k", "GAN archs use their own image shapes")
    if shape.name == "long_500k" and not cfg.subquadratic:
        return (False, "pure full-attention arch: 500k dense-KV decode skipped per DESIGN.md")
    return (True, "")
