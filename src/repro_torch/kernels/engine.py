"""The Winograd engines and their backward: wrappers of the CUDA kernels
``csrc/fused_engine.cu``, ``csrc/fused_engine_bwd.cu``, ``csrc/conv_engine.cu``
and ``csrc/domain_engine.cu`` and their plain PyTorch versions.

``fused_engine`` takes the padded cell layout of one deconv layer and the
packed (C, N, M) weights and returns either the cropped NHWC image
(``out_mode="nhwc"``) or the next layer's exact cell layout
(``out_mode="cells"``), with the per-channel affine and the activation
applied, or the folded tile outputs (B, ty, tx, S*S*m*m, M) with no
epilogue (``out_mode="scratch"``).  On a CUDA tensor it launches the kernel
(or raises); on a CPU tensor it runs ``fused_engine_plain``.
``fused_engine.launches`` counts its launches with an epilogue (nhwc,
cells) and ``fused_engine.scratch_launches`` those in scratch mode, and
nothing else: the reference's two kernels of one function.

``fused_engine_bwd_x`` and ``fused_engine_bwd_w`` are the two cotangents of
the engine's pre-epilogue products, from the cotangent ``g`` in the
(B, ty, tx, S*S*m*m, M) scratch layout: dL/dcells (B, gy, gx, m*m, N) and
dL/dww (C, N, M).  They follow the same contract and keep their own
``.launches``.

``conv_fused_engine`` and ``conv_fused_engine_bwd_x`` / ``_bwd_w`` are the
same three at the engine's strided-conv corner (S^2 input phases in
phase-major cells (B, Gy, Gx, S^2*m*m, N), one sub-filter over all C packed
positions, stride 1, no padding), with the same contract.

``domain_engine`` and ``domain_engine_bwd_x`` / ``_bwd_w`` are the unfused
engine of the per-layer path: the transformed tiles xw (T, n*n, N) come in
from device memory, the output is the (T, S*S*m*m, M) tile outputs, and
the backward gives dxw (T, n*n, N) and dww (C, N, M).  Same contract.
"""
from __future__ import annotations

import functools

import torch

from ..core.winograd import get_transform
from . import ref as _ref
from .ref import EPILOGUE_ACTIVATIONS, LEAKY_SLOPE

__all__ = [
    "LEAKY_SLOPE", "EPILOGUE_ACTIVATIONS", "fused_engine", "fused_engine_plain",
    "fused_engine_bwd_x", "fused_engine_bwd_x_plain", "fused_engine_bwd_w", "fused_engine_bwd_w_plain",
    "conv_fused_engine", "conv_fused_engine_plain", "conv_fused_engine_bwd_x", "conv_fused_engine_bwd_x_plain",
    "conv_fused_engine_bwd_w", "conv_fused_engine_bwd_w_plain", "domain_engine", "domain_engine_plain",
    "domain_engine_bwd_x", "domain_engine_bwd_x_plain", "domain_engine_bwd_w", "domain_engine_bwd_w_plain",
]

_OUT_MODES = {"nhwc": 0, "cells": 1, "scratch": 2}
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
    ``fused_epilogue_engine_ref``, cropped in nhwc mode, or in scratch mode
    its ``fused_pre_engine_ref``."""
    if out_mode == "scratch":
        return _ref.fused_pre_engine_ref(cells, ww_packed, inv_packed, _bt(m, n), pos_idx=pos_idx,
                                         sub_slices=sub_slices, m=m, n=n, ty=ty, tx=tx, m2=m * m)
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
    out_mode: str,  # "nhwc" | "cells" | "scratch"
    activation: str = "none",
    scale: torch.Tensor | None = None,  # (M,) per-channel epilogue scale
    bias: torch.Tensor | None = None,  # (M,) per-channel epilogue bias
    stride: int,
    padding: int,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """Epilogue-fused engine at the deconv corner (one input phase, stride S).

    Returns (B, out_h, out_w, M) in nhwc mode, (B, ty*S, tx*S, m*m, M) in
    cells mode with pixels outside the crop window zeroed, or the tile
    outputs (B, ty, tx, S*S*m*m, M) in scratch mode (no epilogue).  CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    takes F(2,3) only, fp32, contiguous inputs."""
    if out_mode not in _OUT_MODES:
        raise ValueError(f"out_mode {out_mode!r} not in {tuple(_OUT_MODES)}")
    if activation not in _ACT_CODES:
        raise ValueError(f"unsupported epilogue activation {activation!r}")
    if out_mode == "scratch" and (activation != "none" or scale is not None or bias is not None):
        raise ValueError("scratch mode has no epilogue: activation 'none', no scale, no bias")
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
    out_shape = {"nhwc": (B, out_h, out_w, M), "cells": (B, ty * S, tx * S, m * m, M),
                 "scratch": (B, ty, tx, S * S * m * m, M)}[out_mode]
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
    if out_mode == "scratch":
        fused_engine.scratch_launches += 1
    else:
        fused_engine.launches += 1
    return out


fused_engine.launches = 0
fused_engine.scratch_launches = 0


# ------------------------------------------------------------- backward
def fused_engine_bwd_x_plain(
    g: torch.Tensor,
    ww_packed: torch.Tensor,
    inv_packed: torch.Tensor,
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    gy: int,
    gx: int,
    stride: int,
) -> torch.Tensor:
    """Plain PyTorch version of the bwd_x kernel, on any device: the
    reference's ``fused_pre_engine_bwd_x_ref``."""
    return _ref.fused_pre_engine_bwd_x_ref(
        g, ww_packed, inv_packed, _bt(m, n), pos_idx=pos_idx, sub_slices=sub_slices,
        m=m, n=n, ty=ty, tx=tx, gy=gy, gx=gx, m2=m * m,
    )


def fused_engine_bwd_w_plain(
    cells: torch.Tensor,
    g: torch.Tensor,
    inv_packed: torch.Tensor,
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    stride: int,
) -> torch.Tensor:
    """Plain PyTorch version of the bwd_w kernel, on any device: the
    reference's ``fused_pre_engine_bwd_w_ref``."""
    return _ref.fused_pre_engine_bwd_w_ref(
        cells, g, inv_packed, _bt(m, n), pos_idx=pos_idx, sub_slices=sub_slices,
        m=m, n=n, ty=ty, tx=tx, m2=m * m,
    )


def _check_bwd(name: str, g: torch.Tensor, others, *, pos_idx, sub_slices, m, n, ty, tx, stride):
    """The checks both backward kernels share; returns (B, M, C).  Raises on
    a wrong device, dtype, contiguity or geometry: nothing falls back."""
    dev = g.device
    for nm, t in (("g", g), *others):
        if t.device != dev or t.dtype is not torch.float32 or not t.is_contiguous():
            raise ValueError(f"{nm} must be a contiguous fp32 tensor on {dev}, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if (m, n) != (2, 4):
        raise ValueError(f"the CUDA kernels implement F(2,3) only (m=2, n=4), got m={m}, n={n}")
    S = stride
    if not 1 <= S <= 4:
        raise ValueError(f"stride {S} outside the kernels' 1..4")
    if g.dim() != 5 or tuple(g.shape[1:4]) != (ty, tx, S * S * m * m):
        raise ValueError(f"g must be (B, {ty}, {tx}, {S * S * m * m}, M), got {tuple(g.shape)}")
    C = len(pos_idx)
    if len(sub_slices) != S * S or sub_slices[0][0] != 0 or sub_slices[-1][1] != C or \
            any(sub_slices[i][1] != sub_slices[i + 1][0] for i in range(S * S - 1)):
        raise ValueError(f"sub_slices {sub_slices} must be S^2 = {S * S} slices tiling [0, {C}) in order")
    if any(hi - lo > n * n for lo, hi in sub_slices):
        raise ValueError(f"a sub-filter holds more than {n * n} positions")
    B, M = g.shape[0], g.shape[4]
    if min(B, M, ty, tx) <= 0:
        raise ValueError("empty problem")
    return B, M, C


def fused_engine_bwd_x(
    g: torch.Tensor,  # (B, ty, tx, S*S*m*m, M) cotangent of the engine's products
    ww_packed: torch.Tensor,  # (C, N, M)
    inv_packed: torch.Tensor,  # (C, m*m) fp32
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    gy: int,
    gx: int,
    stride: int,
) -> torch.Tensor:
    """dL/dcells (B, gy, gx, m*m, N) of the fused engine at the deconv
    corner: the exact shape of the forward's cells input, zero in rows and
    columns the forward never reads.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (F(2,3), fp32, contiguous inputs)."""
    kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m=m, n=n, ty=ty, tx=tx, stride=stride)
    if g.device.type == "cpu":
        return fused_engine_bwd_x_plain(g, ww_packed, inv_packed, gy=gy, gx=gx, **kw)
    if g.device.type != "cuda":
        raise ValueError(f"fused_engine_bwd_x runs on cpu or cuda tensors, got {g.device}")
    B, M, C = _check_bwd("g", g, (("ww_packed", ww_packed), ("inv_packed", inv_packed)), **kw)
    if ww_packed.dim() != 3 or ww_packed.shape[0] != C or ww_packed.shape[2] != M:
        raise ValueError(f"ww_packed must be ({C}, N, {M}), got {tuple(ww_packed.shape)}")
    if inv_packed.shape != (C, m * m):
        raise ValueError(f"inv_packed must be ({C}, {m * m}), got {tuple(inv_packed.shape)}")
    N = ww_packed.shape[1]
    if gy < ty + 1 or gx < tx + 1:
        raise ValueError(f"cells ({gy}, {gx}) do not cover {ty}x{tx} tiles plus the halo")
    out_shape = (B, gy, gx, m * m, N)
    if max(g.numel(), ww_packed.numel(), B * gy * gx * m * m * N) >= 2**31:
        raise ValueError("problem too large for the kernel's 32-bit indices")

    from ._build import load_library

    dev = g.device
    lib = load_library()
    pos, offs = _layout_tensors(tuple(pos_idx), tuple(sub_slices), str(dev))
    R, W, TC = _bwd_x_plan(B, gy, gx, ty, tx, M, dev.index)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    err = lib.fused_engine_bwd_x_f32(
        g.data_ptr(), ww_packed.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), offs.data_ptr(),
        out.data_ptr(), B, gy, gx, N, M, stride, ty, tx, R, W, TC,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_engine_bwd_x kernel launch failed: cudaError {err}")
    fused_engine_bwd_x.launches += 1
    return out


fused_engine_bwd_x.launches = 0


def fused_engine_bwd_w(
    cells: torch.Tensor,  # (B, Gy, Gx, m*m, N) the forward's cells input
    g: torch.Tensor,  # (B, ty, tx, S*S*m*m, M)
    inv_packed: torch.Tensor,  # (C, m*m) fp32
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    stride: int,
) -> torch.Tensor:
    """dL/dww (C, N, M) of the fused engine at the deconv corner, xw
    recomputed from the cells.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (F(2,3), fp32, contiguous, N % 4 == 0)."""
    kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m=m, n=n, ty=ty, tx=tx, stride=stride)
    if g.device.type == "cpu":
        return fused_engine_bwd_w_plain(cells, g, inv_packed, **kw)
    if g.device.type != "cuda":
        raise ValueError(f"fused_engine_bwd_w runs on cpu or cuda tensors, got {g.device}")
    B, M, C = _check_bwd("g", g, (("cells", cells), ("inv_packed", inv_packed)), **kw)
    if cells.dim() != 5 or cells.shape[0] != B or cells.shape[3] != m * m:
        raise ValueError(f"cells must be ({B}, Gy, Gx, {m * m}, N), got {tuple(cells.shape)}")
    if inv_packed.shape != (C, m * m):
        raise ValueError(f"inv_packed must be ({C}, {m * m}), got {tuple(inv_packed.shape)}")
    _, Gy, Gx, _, N = cells.shape
    if Gy < ty + 1 or Gx < tx + 1:
        raise ValueError(f"cells ({Gy}, {Gx}) do not cover {ty}x{tx} tiles plus the halo")
    if N % 4:
        raise ValueError(f"the CUDA kernel moves cell windows in 16-byte copies: N={N} must be a multiple of 4")
    if max(cells.numel(), g.numel(), C * N * M) >= 2**31 or B * ty * tx >= 2**31:
        raise ValueError("problem too large for the kernel's 32-bit indices")

    from ._build import load_library

    dev = g.device
    lib = load_library()
    pos, offs = _layout_tensors(tuple(pos_idx), tuple(sub_slices), str(dev))
    splits, n_scratch, n_counters = _bwd_w_plan(B, ty, tx, N, M, stride, dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = torch.empty(n_scratch, dtype=torch.float32, device=dev) if n_scratch else None
    counters = _split_counters(n_counters, dev.index, stream) if n_counters else None
    out = torch.empty((C, N, M), dtype=torch.float32, device=dev)
    err = lib.fused_engine_bwd_w_f32(
        cells.data_ptr(), g.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), offs.data_ptr(),
        out.data_ptr(), B, Gy, Gx, N, M, stride, ty, tx, splits,
        None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_engine_bwd_w kernel launch failed: cudaError {err}")
    fused_engine_bwd_w.launches += 1
    return out


fused_engine_bwd_w.launches = 0


@functools.lru_cache(maxsize=256)
def _bwd_x_plan(B: int, gy: int, gx: int, ty: int, tx: int, M: int, device_index: int):
    """(R, W, TC) of the bwd_x kernel's block geometry for this shape: R
    cell rows by W cell columns per block, TC tile columns per slot row.
    The library raises the kernel's shared-memory limit here, once."""
    import ctypes

    from ._build import load_library

    out = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(device_index):
        err = load_library().fused_engine_bwd_x_plan(B, gy, gx, ty, tx, M, *map(ctypes.byref, out))
    if err != 0:
        raise RuntimeError(f"fused_engine_bwd_x plan failed: cudaError {err}")
    return tuple(v.value for v in out)


@functools.lru_cache(maxsize=256)
def _bwd_w_plan(B: int, ty: int, tx: int, N: int, M: int, S: int, device_index: int):
    """(splits, scratch floats, counters) of the bwd_w kernel's T-loop split
    for this shape on this card; the library raises the kernel's
    shared-memory limit here, once."""
    import ctypes

    from ._build import load_library

    splits, floats, counters = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_longlong()
    with torch.cuda.device(device_index):
        err = load_library().fused_engine_bwd_w_plan(B, ty, tx, N, M, S, device_index, ctypes.byref(splits),
                                                     ctypes.byref(floats), ctypes.byref(counters))
    if err != 0:
        raise RuntimeError(f"fused_engine_bwd_w plan failed: cudaError {err}")
    return splits.value, floats.value, counters.value


# ------------------------------------------------------------- conv corner
def conv_fused_engine_plain(
    cells: torch.Tensor,
    ww_packed: torch.Tensor,
    inv_packed: torch.Tensor,
    *,
    pos_idx: tuple[int, ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    s2: int,
    out_mode: str,
    activation: str = "none",
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """Plain PyTorch version of the conv kernel, on any device: the
    reference's ``conv_engine_ref``, cropped in nhwc mode."""
    y = _ref.conv_engine_ref(
        cells, ww_packed, inv_packed, _bt(m, n), scale, bias, pos_idx=pos_idx, m=m, n=n, ty=ty, tx=tx,
        s2=s2, out_mode=out_mode, activation=activation, out_h=out_h, out_w=out_w,
    )
    return y[:, :out_h, :out_w, :].contiguous() if out_mode == "nhwc" else y


def conv_fused_engine_bwd_x_plain(
    g: torch.Tensor,
    ww_packed: torch.Tensor,
    inv_packed: torch.Tensor,
    *,
    pos_idx: tuple[int, ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    gy: int,
    gx: int,
    s2: int,
) -> torch.Tensor:
    """Plain PyTorch version of the conv bwd_x kernel, on any device: the
    VJP of ``conv_pre_engine_ref`` in the cells."""
    return _ref.conv_engine_bwd_x_ref(g, ww_packed, inv_packed, _bt(m, n), pos_idx=pos_idx, m=m, n=n,
                                      ty=ty, tx=tx, gy=gy, gx=gx, s2=s2)


def conv_fused_engine_bwd_w_plain(
    cells: torch.Tensor,
    g: torch.Tensor,
    inv_packed: torch.Tensor,
    *,
    pos_idx: tuple[int, ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    s2: int,
) -> torch.Tensor:
    """Plain PyTorch version of the conv bwd_w kernel, on any device: the
    VJP of ``conv_pre_engine_ref`` in the packed weights."""
    return _ref.conv_engine_bwd_w_ref(cells, g, inv_packed, _bt(m, n), pos_idx=pos_idx, m=m, n=n,
                                      ty=ty, tx=tx, s2=s2)


@functools.lru_cache(maxsize=64)
def _conv_layout_tensors(pos_idx: tuple[int, ...], s2: int, device: str):
    """Packed positions and each phase's first packed position as small
    int32 device tensors, built once per layer geometry and device.  The
    kernels take positions grouped by phase, at most n^2 = 16 distinct ones
    per phase."""
    phase = [p // 16 for p in pos_idx]
    if not 1 <= s2 <= 16 or phase != sorted(phase) or any(not 0 <= q < s2 for q in phase) \
            or len(set(pos_idx)) != len(pos_idx):
        raise ValueError(f"pos_idx {pos_idx} is not grouped by phase into {s2} phases of distinct positions")
    off = [sum(q < s for q in phase) for s in range(s2 + 1)]
    return (torch.tensor(pos_idx, dtype=torch.int32, device=device),
            torch.tensor(off, dtype=torch.int32, device=device))


def _check_conv(tensors, *, m, n, ty, tx):
    """Checks every conv-corner kernel shares: device, dtype, contiguity,
    F(2,3).  Raises: nothing falls back."""
    dev = tensors[0][1].device
    for name, t in tensors:
        if t.device != dev or t.dtype is not torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 tensor on {dev}, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if (m, n) != (2, 4):
        raise ValueError(f"the CUDA kernels implement F(2,3) only (m=2, n=4), got m={m}, n={n}")
    if min(ty, tx) <= 0:
        raise ValueError("empty problem")
    return dev


def _check_conv_cells(cells, B, ty, tx, s2, N=None):
    if cells.dim() != 5 or cells.shape[0] != B or cells.shape[3] != s2 * 4 or (N is not None and cells.shape[4] != N):
        raise ValueError(f"cells must be ({B}, Gy, Gx, {s2 * 4}, {'N' if N is None else N}), "
                         f"got {tuple(cells.shape)}")
    if cells.shape[1] < ty + 1 or cells.shape[2] < tx + 1:
        raise ValueError(f"cells {tuple(cells.shape[1:3])} do not cover {ty}x{tx} tiles plus the halo")


def conv_fused_engine(
    cells: torch.Tensor,  # (B, Gy, Gx, s2*m*m, N) phase-major cell layout
    ww_packed: torch.Tensor,  # (C, N, M)
    inv_packed: torch.Tensor,  # (C, m*m) fp32
    *,
    pos_idx: tuple[int, ...],  # packed position -> s2*n^2 phase-major position
    m: int,
    n: int,
    ty: int,
    tx: int,
    s2: int,
    out_mode: str,  # "nhwc" | "cells"
    activation: str = "none",
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """Epilogue-fused engine at the conv corner: returns (B, out_h, out_w, M)
    in nhwc mode, or (B, ty, tx, m*m, M) in cells mode with pixels outside
    [0, out_h) x [0, out_w) zeroed.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (F(2,3), fp32, contiguous inputs)."""
    if out_mode not in _OUT_MODES:
        raise ValueError(f"out_mode {out_mode!r} not in {tuple(_OUT_MODES)}")
    if activation not in _ACT_CODES:
        raise ValueError(f"unsupported epilogue activation {activation!r}")
    kw = dict(pos_idx=pos_idx, m=m, n=n, ty=ty, tx=tx, s2=s2)
    if cells.device.type == "cpu":
        return conv_fused_engine_plain(cells, ww_packed, inv_packed, out_mode=out_mode, activation=activation,
                                       scale=scale, bias=bias, out_h=out_h, out_w=out_w, **kw)
    if cells.device.type != "cuda":
        raise ValueError(f"conv_fused_engine runs on cpu or cuda tensors, got {cells.device}")
    dev = _check_conv((("cells", cells), ("ww_packed", ww_packed), ("inv_packed", inv_packed)), m=m, n=n, ty=ty, tx=tx)
    C = len(pos_idx)
    if ww_packed.dim() != 3 or ww_packed.shape[0] != C or inv_packed.shape != (C, m * m):
        raise ValueError(f"ww_packed {tuple(ww_packed.shape)} / inv_packed {tuple(inv_packed.shape)} do not "
                         f"hold C={C} positions")
    _, N, M = ww_packed.shape
    B = cells.shape[0]
    _check_conv_cells(cells, B, ty, tx, s2, N)
    if not (0 < out_h <= 2 * ty and 0 < out_w <= 2 * tx) or min(B, N, M) <= 0:
        raise ValueError(f"out ({out_h}, {out_w}) outside the {ty}x{tx} tiles, or an empty problem")
    out_shape = (B, out_h, out_w, M) if out_mode == "nhwc" else (B, ty, tx, m * m, M)
    if max(cells.numel(), ww_packed.numel(), B * ty * tx * 4 * M) >= 2**31:
        raise ValueError("problem too large for the kernel's 32-bit indices")
    scale = _check_vec("scale", scale, M, dev)
    bias = _check_vec("bias", bias, M, dev)
    pos, off = _conv_layout_tensors(tuple(pos_idx), s2, str(dev))

    from ._build import load_library

    lib = load_library()
    _conv_fwd_plan(N, M, dev.index)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    err = lib.conv_engine_fwd_f32(
        cells.data_ptr(), ww_packed.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), off.data_ptr(),
        None if scale is None else scale.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
        B, cells.shape[1], cells.shape[2], N, M, s2, ty, tx, out_h, out_w,
        _OUT_MODES[out_mode], _ACT_CODES[activation], torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"conv_fused_engine kernel launch failed: cudaError {err}")
    conv_fused_engine.launches += 1
    return out


conv_fused_engine.launches = 0


def conv_fused_engine_bwd_x(
    g: torch.Tensor,  # (B, ty, tx, m*m, M) cotangent of the engine's products
    ww_packed: torch.Tensor,  # (C, N, M)
    inv_packed: torch.Tensor,  # (C, m*m) fp32
    *,
    pos_idx: tuple[int, ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    gy: int,
    gx: int,
    s2: int,
) -> torch.Tensor:
    """dL/dcells (B, gy, gx, s2*m*m, N) of the conv engine's products, zero
    in rows and columns the forward never reads.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    kw = dict(pos_idx=pos_idx, m=m, n=n, ty=ty, tx=tx, s2=s2)
    if g.device.type == "cpu":
        return conv_fused_engine_bwd_x_plain(g, ww_packed, inv_packed, gy=gy, gx=gx, **kw)
    if g.device.type != "cuda":
        raise ValueError(f"conv_fused_engine_bwd_x runs on cpu or cuda tensors, got {g.device}")
    dev = _check_conv((("g", g), ("ww_packed", ww_packed), ("inv_packed", inv_packed)), m=m, n=n, ty=ty, tx=tx)
    C = len(pos_idx)
    if ww_packed.dim() != 3 or ww_packed.shape[0] != C or inv_packed.shape != (C, m * m):
        raise ValueError(f"ww_packed {tuple(ww_packed.shape)} / inv_packed {tuple(inv_packed.shape)} do not "
                         f"hold C={C} positions")
    _, N, M = ww_packed.shape
    if g.dim() != 5 or tuple(g.shape[1:]) != (ty, tx, m * m, M):
        raise ValueError(f"g must be (B, {ty}, {tx}, {m * m}, {M}), got {tuple(g.shape)}")
    B = g.shape[0]
    if gy < ty + 1 or gx < tx + 1 or min(B, N, M) <= 0:
        raise ValueError(f"cells ({gy}, {gx}) do not cover {ty}x{tx} tiles plus the halo, or an empty problem")
    if max(g.numel(), ww_packed.numel(), B * gy * gx * s2 * 4 * N) >= 2**31:
        raise ValueError("problem too large for the kernel's 32-bit indices")
    pos, off = _conv_layout_tensors(tuple(pos_idx), s2, str(dev))

    from ._build import load_library

    lib = load_library()
    R, W, TC = _conv_bwd_x_plan(B, gy, gx, ty, tx, N, M, dev.index)
    out = torch.empty((B, gy, gx, s2 * m * m, N), dtype=torch.float32, device=dev)
    err = lib.conv_engine_bwd_x_f32(
        g.data_ptr(), ww_packed.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), off.data_ptr(),
        out.data_ptr(), B, gy, gx, N, M, s2, ty, tx, R, W, TC, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"conv_fused_engine_bwd_x kernel launch failed: cudaError {err}")
    conv_fused_engine_bwd_x.launches += 1
    return out


conv_fused_engine_bwd_x.launches = 0


def conv_fused_engine_bwd_w(
    cells: torch.Tensor,  # (B, Gy, Gx, s2*m*m, N) the forward's cells input
    g: torch.Tensor,  # (B, ty, tx, m*m, M)
    inv_packed: torch.Tensor,  # (C, m*m) fp32
    *,
    pos_idx: tuple[int, ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    s2: int,
) -> torch.Tensor:
    """dL/dww (C, N, M) of the conv engine's products, xw recomputed from
    the cells.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    kw = dict(pos_idx=pos_idx, m=m, n=n, ty=ty, tx=tx, s2=s2)
    if g.device.type == "cpu":
        return conv_fused_engine_bwd_w_plain(cells, g, inv_packed, **kw)
    if g.device.type != "cuda":
        raise ValueError(f"conv_fused_engine_bwd_w runs on cpu or cuda tensors, got {g.device}")
    dev = _check_conv((("g", g), ("cells", cells), ("inv_packed", inv_packed)), m=m, n=n, ty=ty, tx=tx)
    C = len(pos_idx)
    if inv_packed.shape != (C, m * m):
        raise ValueError(f"inv_packed must be ({C}, {m * m}), got {tuple(inv_packed.shape)}")
    if g.dim() != 5 or tuple(g.shape[1:4]) != (ty, tx, m * m):
        raise ValueError(f"g must be (B, {ty}, {tx}, {m * m}, M), got {tuple(g.shape)}")
    B, M = g.shape[0], g.shape[4]
    _check_conv_cells(cells, B, ty, tx, s2)
    N = cells.shape[4]
    if min(B, N, M) <= 0:
        raise ValueError("empty problem")
    if max(cells.numel(), g.numel(), C * N * M) >= 2**31:
        raise ValueError("problem too large for the kernel's 32-bit indices")
    pos, off = _conv_layout_tensors(tuple(pos_idx), s2, str(dev))

    from ._build import load_library

    lib = load_library()
    splits, n_scratch, n_counters = _conv_bwd_w_plan(B, ty, tx, N, M, s2, dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = torch.empty(n_scratch, dtype=torch.float32, device=dev) if n_scratch else None
    counters = _split_counters(n_counters, dev.index, stream) if n_counters else None
    out = torch.empty((C, N, M), dtype=torch.float32, device=dev)
    err = lib.conv_engine_bwd_w_f32(
        cells.data_ptr(), g.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), off.data_ptr(), out.data_ptr(),
        B, cells.shape[1], cells.shape[2], N, M, s2, ty, tx, splits,
        None if partial is None else partial.data_ptr(), None if counters is None else counters.data_ptr(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"conv_fused_engine_bwd_w kernel launch failed: cudaError {err}")
    conv_fused_engine_bwd_w.launches += 1
    return out


conv_fused_engine_bwd_w.launches = 0


@functools.lru_cache(maxsize=64)
def _conv_fwd_plan(N: int, M: int, device_index: int) -> None:
    """Raise the conv forward kernel's shared-memory limit for (N, M)'s block
    configuration, once per device."""
    from ._build import load_library

    with torch.cuda.device(device_index):
        err = load_library().conv_engine_fwd_plan(N, M)
    if err != 0:
        raise RuntimeError(f"conv_fused_engine plan failed: cudaError {err}")


@functools.lru_cache(maxsize=256)
def _conv_bwd_x_plan(B: int, gy: int, gx: int, ty: int, tx: int, N: int, M: int, device_index: int):
    """(R, W, TC) of the conv bwd_x kernel's block geometry for this shape;
    the library raises the kernel's shared-memory limit here, once."""
    import ctypes

    from ._build import load_library

    out = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(device_index):
        err = load_library().conv_engine_bwd_x_plan(B, gy, gx, ty, tx, N, M, *map(ctypes.byref, out))
    if err != 0:
        raise RuntimeError(f"conv_fused_engine_bwd_x plan failed: cudaError {err}")
    return tuple(v.value for v in out)


@functools.lru_cache(maxsize=256)
def _conv_bwd_w_plan(B: int, ty: int, tx: int, N: int, M: int, s2: int, device_index: int):
    """(splits, scratch floats, counters) of the conv bwd_w kernel's T-loop
    split for this shape on this card; the library raises the kernel's
    shared-memory limit here, once."""
    import ctypes

    from ._build import load_library

    splits, floats, counters = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_longlong()
    with torch.cuda.device(device_index):
        err = load_library().conv_engine_bwd_w_plan(B, ty, tx, N, M, s2, device_index, ctypes.byref(splits),
                                                    ctypes.byref(floats), ctypes.byref(counters))
    if err != 0:
        raise RuntimeError(f"conv_fused_engine_bwd_w plan failed: cudaError {err}")
    return splits.value, floats.value, counters.value


# ------------------------------------------------------------- unfused engine
def domain_engine_plain(
    xw: torch.Tensor,
    ww_packed: torch.Tensor,
    inv_packed: torch.Tensor,
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m2: int,
) -> torch.Tensor:
    """Plain PyTorch version of the unfused kernel, on any device: the
    reference's ``engine_ref``."""
    return _ref.engine_ref(xw, ww_packed, inv_packed, pos_idx=pos_idx, sub_slices=sub_slices, m2=m2)


def domain_engine_bwd_x_plain(
    g: torch.Tensor,
    ww_packed: torch.Tensor,
    inv_packed: torch.Tensor,
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m2: int,
    n2: int,
) -> torch.Tensor:
    """Plain PyTorch version of the unfused bwd_x kernel: ``engine_bwd_x_ref``."""
    return _ref.engine_bwd_x_ref(g, ww_packed, inv_packed, pos_idx=pos_idx, sub_slices=sub_slices, m2=m2, n2=n2)


def domain_engine_bwd_w_plain(
    xw: torch.Tensor,
    g: torch.Tensor,
    inv_packed: torch.Tensor,
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m2: int,
) -> torch.Tensor:
    """Plain PyTorch version of the unfused bwd_w kernel: ``engine_bwd_w_ref``."""
    return _ref.engine_bwd_w_ref(xw, g, inv_packed, pos_idx=pos_idx, sub_slices=sub_slices, m2=m2)


def _check_domain(tensors, *, pos_idx, sub_slices, m2, T, N, M):
    """The checks the three unfused kernels share: device, dtype,
    contiguity, F(2,3), the packed layout.  Returns (device, S^2).  Raises:
    nothing falls back."""
    dev = tensors[0][1].device
    for name, t in tensors:
        if t.device != dev or t.dtype is not torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 tensor on {dev}, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if m2 != 4:
        raise ValueError(f"the CUDA kernels implement F(2,3) only (m2=4), got m2={m2}")
    s2, C = len(sub_slices), len(pos_idx)
    if not 1 <= s2 <= 16 or sub_slices[0][0] != 0 or sub_slices[-1][1] != C or \
            any(sub_slices[i][1] != sub_slices[i + 1][0] for i in range(s2 - 1)):
        raise ValueError(f"sub_slices {sub_slices} must be 1..16 slices tiling [0, {C}) in order")
    for lo, hi in sub_slices:
        sub = pos_idx[lo:hi]
        if len(set(sub)) != len(sub) or any(not 0 <= p < 16 for p in sub):
            raise ValueError(f"sub-filter positions {sub} must be distinct, in [0, 16)")
    if min(T, N, M) <= 0:
        raise ValueError("empty problem")
    if max(T * 16 * N, T * s2 * 4 * M, C * N * M) >= 2**31:
        raise ValueError("problem too large for the kernels' 32-bit indices")
    return dev, s2


def _check_packed(ww_packed, inv_packed, C, N=None, M=None):
    if ww_packed is not None and (ww_packed.dim() != 3 or ww_packed.shape[0] != C
                                  or (N is not None and ww_packed.shape[1] != N)
                                  or (M is not None and ww_packed.shape[2] != M)):
        raise ValueError(f"ww_packed must be ({C}, {N or 'N'}, {M or 'M'}), got {tuple(ww_packed.shape)}")
    if inv_packed.shape != (C, 4):
        raise ValueError(f"inv_packed must be ({C}, 4), got {tuple(inv_packed.shape)}")


def domain_engine(
    xw: torch.Tensor,  # (T, n*n, N) transformed input tiles
    ww_packed: torch.Tensor,  # (C, N, M)
    inv_packed: torch.Tensor,  # (C, m*m) fp32
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m2: int,
) -> torch.Tensor:
    """The unfused engine: the (T, S*S*m*m, M) tile outputs of every
    sub-filter, sub-filter-major.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (F(2,3), fp32, contiguous, N % 4 == 0)."""
    kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m2=m2)
    if xw.device.type == "cpu":
        return domain_engine_plain(xw, ww_packed, inv_packed, **kw)
    if xw.device.type != "cuda":
        raise ValueError(f"domain_engine runs on cpu or cuda tensors, got {xw.device}")
    if xw.dim() != 3 or xw.shape[1] != 16 or ww_packed.dim() != 3:
        raise ValueError(f"xw must be (T, 16, N) and ww_packed (C, N, M), got {tuple(xw.shape)}, "
                         f"{tuple(ww_packed.shape)}")
    T, _, N = xw.shape
    M = ww_packed.shape[2]
    dev, s2 = _check_domain((("xw", xw), ("ww_packed", ww_packed), ("inv_packed", inv_packed)), T=T, N=N, M=M,
                            **kw)
    _check_packed(ww_packed, inv_packed, len(pos_idx), N)
    if N % 4:
        raise ValueError(f"the CUDA kernel moves xw in 16-byte copies: N={N} must be a multiple of 4")

    from ._build import load_library

    lib = load_library()
    pos, offs = _layout_tensors(tuple(pos_idx), tuple(sub_slices), str(dev))
    splits, n_scratch, n_counters = _domain_plan("fwd", T, N, M, s2, dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = torch.empty(n_scratch, dtype=torch.float32, device=dev) if n_scratch else None
    counters = _split_counters(n_counters, dev.index, stream) if n_counters else None
    out = torch.empty((T, s2 * 4, M), dtype=torch.float32, device=dev)
    err = lib.domain_engine_fwd_f32(
        xw.data_ptr(), ww_packed.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), offs.data_ptr(),
        out.data_ptr(), T, N, M, s2, splits, None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"domain_engine kernel launch failed: cudaError {err}")
    domain_engine.launches += 1
    return out


domain_engine.launches = 0


def domain_engine_bwd_x(
    g: torch.Tensor,  # (T, S*S*m*m, M) cotangent of the tile outputs
    ww_packed: torch.Tensor,  # (C, N, M)
    inv_packed: torch.Tensor,  # (C, m*m) fp32
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m2: int,
    n2: int,
) -> torch.Tensor:
    """dL/dxw (T, n*n, N) of the unfused engine, zero at the Winograd
    positions no packed position keeps.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (F(2,3), fp32, contiguous)."""
    kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m2=m2)
    if g.device.type == "cpu":
        return domain_engine_bwd_x_plain(g, ww_packed, inv_packed, n2=n2, **kw)
    if g.device.type != "cuda":
        raise ValueError(f"domain_engine_bwd_x runs on cpu or cuda tensors, got {g.device}")
    if n2 != 16 or g.dim() != 3 or g.shape[1] != len(sub_slices) * 4 or ww_packed.dim() != 3:
        raise ValueError(f"g must be (T, {len(sub_slices) * 4}, M) with n2 = 16 and ww_packed (C, N, M), got "
                         f"{tuple(g.shape)}, n2={n2}, {tuple(ww_packed.shape)}")
    T, _, M = g.shape
    N = ww_packed.shape[1]
    dev, s2 = _check_domain((("g", g), ("ww_packed", ww_packed), ("inv_packed", inv_packed)), T=T, N=N, M=M,
                            **kw)
    _check_packed(ww_packed, inv_packed, len(pos_idx), N, M)

    from ._build import load_library

    lib = load_library()
    pos, offs = _layout_tensors(tuple(pos_idx), tuple(sub_slices), str(dev))
    _domain_bwd_x_plan(M, dev.index)
    out = torch.empty((T, 16, N), dtype=torch.float32, device=dev)
    err = lib.domain_engine_bwd_x_f32(
        g.data_ptr(), ww_packed.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), offs.data_ptr(),
        out.data_ptr(), T, N, M, s2, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"domain_engine_bwd_x kernel launch failed: cudaError {err}")
    domain_engine_bwd_x.launches += 1
    return out


domain_engine_bwd_x.launches = 0


def domain_engine_bwd_w(
    xw: torch.Tensor,  # (T, n*n, N) the forward's transformed tiles
    g: torch.Tensor,  # (T, S*S*m*m, M)
    inv_packed: torch.Tensor,  # (C, m*m) fp32
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m2: int,
) -> torch.Tensor:
    """dL/dww (C, N, M) of the unfused engine.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (F(2,3), fp32, contiguous,
    N % 4 == 0)."""
    kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m2=m2)
    if g.device.type == "cpu":
        return domain_engine_bwd_w_plain(xw, g, inv_packed, **kw)
    if g.device.type != "cuda":
        raise ValueError(f"domain_engine_bwd_w runs on cpu or cuda tensors, got {g.device}")
    if xw.dim() != 3 or xw.shape[1] != 16 or g.dim() != 3 or g.shape[0] != xw.shape[0] or \
            g.shape[1] != len(sub_slices) * 4:
        raise ValueError(f"xw must be (T, 16, N) and g (T, {len(sub_slices) * 4}, M), got {tuple(xw.shape)}, "
                         f"{tuple(g.shape)}")
    T, _, N = xw.shape
    M = g.shape[2]
    dev, s2 = _check_domain((("g", g), ("xw", xw), ("inv_packed", inv_packed)), T=T, N=N, M=M, **kw)
    _check_packed(None, inv_packed, len(pos_idx))
    if N % 4:
        raise ValueError(f"the CUDA kernel moves xw in 16-byte copies: N={N} must be a multiple of 4")

    from ._build import load_library

    lib = load_library()
    pos, offs = _layout_tensors(tuple(pos_idx), tuple(sub_slices), str(dev))
    splits, n_scratch, n_counters = _domain_plan("bwd_w", T, N, M, s2, dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = torch.empty(n_scratch, dtype=torch.float32, device=dev) if n_scratch else None
    counters = _split_counters(n_counters, dev.index, stream) if n_counters else None
    out = torch.empty((len(pos_idx), N, M), dtype=torch.float32, device=dev)
    err = lib.domain_engine_bwd_w_f32(
        xw.data_ptr(), g.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), offs.data_ptr(), out.data_ptr(),
        T, N, M, s2, splits, None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"domain_engine_bwd_w kernel launch failed: cudaError {err}")
    domain_engine_bwd_w.launches += 1
    return out


domain_engine_bwd_w.launches = 0


@functools.lru_cache(maxsize=256)
def _domain_plan(which: str, T: int, N: int, M: int, s2: int, device_index: int):
    """(splits, scratch floats, counters) of the unfused fwd kernel's N split
    or bwd_w kernel's T split for this shape on this card; the library
    raises the kernel's shared-memory limit here, once."""
    import ctypes

    from ._build import load_library

    splits, floats, counters = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_longlong()
    fn = getattr(load_library(), f"domain_engine_{which}_plan")
    with torch.cuda.device(device_index):
        err = fn(T, N, M, s2, device_index, ctypes.byref(splits), ctypes.byref(floats), ctypes.byref(counters))
    if err != 0:
        raise RuntimeError(f"domain_engine {which} plan failed: cudaError {err}")
    return splits.value, floats.value, counters.value


@functools.lru_cache(maxsize=64)
def _domain_bwd_x_plan(M: int, device_index: int) -> None:
    """Raise the unfused bwd_x kernel's shared-memory limit for M's block
    configuration, once per device."""
    from ._build import load_library

    with torch.cuda.device(device_index):
        err = load_library().domain_engine_bwd_x_plan(M)
    if err != 0:
        raise RuntimeError(f"domain_engine_bwd_x plan failed: cudaError {err}")
