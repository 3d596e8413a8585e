"""The epilogue-fused Winograd engine: wrapper of the CUDA kernel
``csrc/fused_engine.cu`` and its plain PyTorch version.

``fused_engine`` takes the padded cell layout of one deconv layer and the
packed (C, N, M) weights and returns either the cropped NHWC image
(``out_mode="nhwc"``) or the next layer's exact cell layout
(``out_mode="cells"``), with the per-channel affine and the activation
applied.  On a CUDA tensor it launches the kernel (or raises); on a CPU
tensor it runs ``fused_engine_plain``.  ``fused_engine.launches`` counts
kernel launches and nothing else.
"""
from __future__ import annotations

import functools

import torch

from ..core.winograd import get_transform
from . import ref as _ref
from .ref import EPILOGUE_ACTIVATIONS, LEAKY_SLOPE

__all__ = ["LEAKY_SLOPE", "EPILOGUE_ACTIVATIONS", "fused_engine", "fused_engine_plain"]

_OUT_MODES = {"nhwc": 0, "cells": 1}
_ACT_CODES = {a: i for i, a in enumerate(EPILOGUE_ACTIVATIONS)}


def fused_engine_plain(
    cells: torch.Tensor,
    ww_packed: torch.Tensor,
    inv_packed: torch.Tensor,
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    out_mode: str,
    activation: str = "none",
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    stride: int,
    padding: int,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the reference's
    ``fused_epilogue_engine_ref``, cropped in nhwc mode."""
    y = _ref.fused_epilogue_engine_ref(
        cells, ww_packed, inv_packed, _bt(m, n), scale, bias,
        pos_idx=pos_idx, sub_slices=sub_slices, m=m, n=n, ty=ty, tx=tx, m2=m * m,
        out_mode=out_mode, activation=activation, stride=stride, padding=padding,
        out_h=out_h, out_w=out_w,
    )
    if out_mode == "nhwc":
        y = y[:, padding : padding + out_h, padding : padding + out_w, :].contiguous()
    return y


def _bt(m: int, n: int):
    """B^T of F(m, n - m + 1) as nested tuples."""
    return tuple(tuple(float(v) for v in row) for row in get_transform(m, n - m + 1).BT)


@functools.lru_cache(maxsize=64)
def _layout_tensors(pos_idx: tuple[int, ...], sub_slices: tuple[tuple[int, int], ...], device: str):
    """Packed positions and sub-filter offsets as small int32 device tensors,
    built once per layer geometry and device."""
    offs = [lo for lo, _ in sub_slices] + [sub_slices[-1][1]]
    pos = torch.tensor(pos_idx if pos_idx else (0,), dtype=torch.int32, device=device)
    return pos, torch.tensor(offs, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=256)
def _plan(B: int, ty: int, tx: int, N: int, M: int, S: int, device_index: int):
    """(splits, scratch floats, counters) the kernel's N-loop split needs for
    this shape on this card, from the library's own block configuration.
    The library also raises the kernel's shared-memory limit here, once per
    block configuration and device, which every launch needs."""
    import ctypes

    from ._build import load_library

    splits, floats, counters = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_longlong()
    with torch.cuda.device(device_index):
        err = load_library().fused_engine_plan(B, ty, tx, N, M, S, device_index, ctypes.byref(splits),
                                               ctypes.byref(floats), ctypes.byref(counters))
    if err != 0:
        raise RuntimeError(f"fused_engine plan failed: cudaError {err}")
    return splits.value, floats.value, counters.value


@functools.lru_cache(maxsize=None)  # a few hundred ints per (shape, stream); never freed under a launch
def _split_counters(n: int, device_index: int, stream: int) -> torch.Tensor:
    """The N-loop split's arrival counters, zeroed once: the kernel leaves
    them at 0.  One buffer per stream, since launches on one stream run in
    order and never share it at the same time."""
    return torch.zeros(n, dtype=torch.int32, device=torch.device("cuda", device_index))


def _check_vec(name, v, M, device):
    if v is None:
        return None
    if v.device != device or v.dtype is not torch.float32 or v.shape != (M,) or not v.is_contiguous():
        raise ValueError(f"{name} must be a contiguous fp32 ({M},) tensor on {device}, got "
                         f"{tuple(v.shape)} {v.dtype} on {v.device}")
    return v


def fused_engine(
    cells: torch.Tensor,  # (B, Gy, Gx, m*m, N) padded cell layout
    ww_packed: torch.Tensor,  # (C, N, M)
    inv_packed: torch.Tensor,  # (C, m*m) fp32
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    out_mode: str,  # "nhwc" | "cells"
    activation: str = "none",
    scale: torch.Tensor | None = None,  # (M,) per-channel epilogue scale
    bias: torch.Tensor | None = None,  # (M,) per-channel epilogue bias
    stride: int,
    padding: int,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """Epilogue-fused engine at the deconv corner (one input phase, stride S).

    Returns (B, out_h, out_w, M) in nhwc mode, or (B, ty*S, tx*S, m*m, M) in
    cells mode with pixels outside the crop window zeroed.  CPU tensors take
    the plain version; CUDA tensors launch the kernel, which takes F(2,3)
    only, fp32, contiguous inputs."""
    if out_mode not in _OUT_MODES:
        raise ValueError(f"out_mode {out_mode!r} not in {tuple(_OUT_MODES)}")
    if activation not in _ACT_CODES:
        raise ValueError(f"unsupported epilogue activation {activation!r}")
    if cells.device.type == "cpu":
        return fused_engine_plain(
            cells, ww_packed, inv_packed, pos_idx=pos_idx, sub_slices=sub_slices, m=m, n=n,
            ty=ty, tx=tx, out_mode=out_mode, activation=activation, scale=scale, bias=bias,
            stride=stride, padding=padding, out_h=out_h, out_w=out_w,
        )
    if cells.device.type != "cuda":
        raise ValueError(f"fused_engine runs on cpu or cuda tensors, got {cells.device}")

    # --- what the kernel takes
    if (m, n) != (2, 4):
        raise ValueError(f"the CUDA kernel implements F(2,3) only (m=2, n=4), got m={m}, n={n}")
    dev = cells.device
    for name, t in (("cells", cells), ("ww_packed", ww_packed), ("inv_packed", inv_packed)):
        if t.device != dev or t.dtype is not torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 tensor on {dev}, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if cells.dim() != 5 or cells.shape[3] != m * m:
        raise ValueError(f"cells must be (B, Gy, Gx, {m * m}, N), got {tuple(cells.shape)}")
    B, Gy, Gx, _, N = cells.shape
    C, Nw, M = ww_packed.shape
    S = stride
    if Nw != N:
        raise ValueError(f"cells carry {N} channels, packed weights {Nw}")
    if inv_packed.shape != (C, m * m) or len(pos_idx) != C:
        raise ValueError(f"inv {tuple(inv_packed.shape)} / pos_idx ({len(pos_idx)}) != C={C}")
    if len(sub_slices) != S * S:
        raise ValueError(f"{len(sub_slices)} sub-filters for stride {S} (the deconv corner has S^2)")
    if any(sub_slices[i][1] != sub_slices[i + 1][0] for i in range(S * S - 1)) or \
            sub_slices[0][0] != 0 or sub_slices[-1][1] != C:
        raise ValueError(f"sub_slices {sub_slices} must tile [0, C) in order")
    if any(hi - lo > n * n for lo, hi in sub_slices):
        raise ValueError(f"a sub-filter holds more than {n * n} positions")
    if Gy < ty + 1 or Gx < tx + 1:
        raise ValueError(f"cells ({Gy}, {Gx}) do not cover {ty}x{tx} tiles plus the halo")
    if min(B, N, M, ty, tx, out_h, out_w) <= 0:
        raise ValueError("empty problem")
    if N % 4:
        raise ValueError(f"the CUDA kernel moves cell windows in 16-byte copies: N={N} must be a multiple of 4")
    out_shape = (B, out_h, out_w, M) if out_mode == "nhwc" else (B, ty * S, tx * S, m * m, M)
    n_out = 1
    for d in out_shape:
        n_out *= d
    if max(cells.numel(), ww_packed.numel(), n_out) >= 2**31 or B * ty * tx >= 2**31:
        raise ValueError("problem too large for the kernel's 32-bit tile indices")
    scale = _check_vec("scale", scale, M, dev)
    bias = _check_vec("bias", bias, M, dev)

    from ._build import load_library

    lib = load_library()
    pos, offs = _layout_tensors(tuple(pos_idx), tuple(sub_slices), str(dev))
    splits, n_scratch, n_counters = _plan(B, ty, tx, N, M, S, dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the N-loop split's partial products and arrival counters
    partial = torch.empty(n_scratch, dtype=torch.float32, device=dev) if n_scratch else None
    counters = _split_counters(n_counters, dev.index, stream) if n_counters else None
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    err = lib.fused_engine_epi_f32(
        cells.data_ptr(), ww_packed.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(),
        offs.data_ptr(), None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        B, Gy, Gx, N, M, S, ty, tx, padding, out_h, out_w,
        _OUT_MODES[out_mode], _ACT_CODES[activation], splits,
        None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_engine kernel launch failed: cudaError {err}")
    fused_engine.launches += 1
    return out


fused_engine.launches = 0
