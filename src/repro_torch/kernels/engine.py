"""The Winograd engines and their backward: wrappers of the CUDA kernels
``csrc/fused_engine.cu``, ``csrc/fused_engine_bwd.cu``, ``csrc/conv_engine.cu``,
``csrc/domain_engine.cu`` and ``csrc/engine1d.cu`` and their plain PyTorch
versions.

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
the backward gives dxw (T, n*n, N) and dww (C, N, M).  Same contract.  The
two backward kernels also take the 1D engine's rank (m2 = 2 outputs and
n2 = phases*n positions per tile), counted apart in ``.rank1_launches``.

``winograd_conv1d_fused_engine`` is the 1D engine (the audio decoder's
deconv1d, strided and unit-stride conv1d): cells (B, Gy, phases*m, N) in,
the folded tile outputs (B, ty, S2*m, M) out (``out_mode="scratch"``,
counted in ``.scratch_launches``) or the epilogue and the stride-S
interleave (B, ty*m*S, M) (``"nlc"``, counted in ``.launches``).  Same
contract.  Its backward, ``winograd_conv1d_fused_bwd_x`` / ``_bwd_w``, is
host code around the rank-1 ``domain_engine_bwd_x`` / ``_bwd_w``, as in
the reference.

Every CUDA wrapper takes ``conf`` (a name from ``INSTANTIATIONS[wrapper]``:
the kernel instantiation to launch, None for its plan's choice) and
``splits`` (the count of its split, None for the plan's: the CUDA-core
forward's N split, the conv forward's pass split, every bwd_w's T split; a
split needs a ``conf`` to name what it splits).  On CPU tensors ``request``
checks them against ``SHAPE_CONDITIONS`` and ``SPLIT_LIMITS`` before the
plain version runs; on CUDA tensors the kernel's C plan judges them.  Either
way a request the shape cannot take raises ValueError.  With neither, every
launch is the plan's own.  While ``launch_log`` is a list, every CUDA launch
appends a ``Launch`` to it: the instantiation and split that ran, and the
plan at that shape.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from ..core.winograd import get_transform
from ..core.winograd_deconv import _bt_on
from . import ref as _ref
from .ref import EPILOGUE_ACTIVATIONS, LEAKY_SLOPE, epilogue_apply_ref, xw_from_cells_1d

__all__ = [
    "INSTANTIATIONS", "SHAPE_CONDITIONS", "SPLIT_LIMITS", "request", "Launch", "launch_log",
    "LEAKY_SLOPE", "EPILOGUE_ACTIVATIONS", "fused_engine", "fused_engine_plain",
    "fused_engine_bwd_x", "fused_engine_bwd_x_plain", "fused_engine_bwd_w", "fused_engine_bwd_w_plain",
    "conv_fused_engine", "conv_fused_engine_plain", "conv_fused_engine_bwd_x", "conv_fused_engine_bwd_x_plain",
    "conv_fused_engine_bwd_w", "conv_fused_engine_bwd_w_plain", "domain_engine", "domain_engine_plain",
    "domain_engine_bwd_x", "domain_engine_bwd_x_plain", "domain_engine_bwd_w", "domain_engine_bwd_w_plain",
    "winograd_conv1d_fused_engine", "winograd_conv1d_fused_engine_plain", "winograd_conv1d_fused_bwd_x",
    "winograd_conv1d_fused_bwd_x_plain", "winograd_conv1d_fused_bwd_w", "winograd_conv1d_fused_bwd_w_plain",
]

_OUT_MODES = {"nhwc": 0, "cells": 1, "scratch": 2}
_ACT_CODES = {a: i for i, a in enumerate(EPILOGUE_ACTIVATIONS)}

# Each CUDA wrapper's kernel instantiations, numbered as its C plan's
# ``want`` takes them: 0 the fp32 CUDA-core kernel (whose block tile follows
# the channel counts, as the plan's own choice does), then the tensor-core
# tiles (BT x BM a block, or BN x BM for bwd_w) in dispatch order; the unfused
# forward's 2 is its few-channel kernel.  These are the ``*_takes`` switches
# beside each source's dispatch (csrc/*.cu), case for case.
INSTANTIATIONS: dict[str, tuple[str, ...]] = {
    "fused_engine": ("cuda_cores", "mma_64x128", "mma_64x64"),
    "fused_engine_bwd_x": ("cuda_cores", "mma_64x32"),
    "fused_engine_bwd_w": ("cuda_cores", "mma_256x128"),
    "conv_fused_engine": ("cuda_cores", "mma_64x128", "mma_64x64"),
    "conv_fused_engine_bwd_x": ("cuda_cores", "mma_128x16", "mma_64x32"),
    "conv_fused_engine_bwd_w": ("cuda_cores", "mma_128x128_t16", "mma_128x128_t8", "mma_64x128"),
    "domain_engine": ("cuda_cores", "mma_128x64", "few_channels"),
    "domain_engine_bwd_x": ("cuda_cores", "mma_64x32", "mma_rank1_128x64", "mma_rank1_64x32"),
    "domain_engine_bwd_w": ("cuda_cores", "mma_256x128", "mma_rank1_256x128", "mma_rank1_128x64"),
    "winograd_conv1d_fused_engine": ("cuda_cores", "mma_64x128", "mma_64x64"),
}

def _mma16(M: int) -> bool:
    return M % 4 == 0 and M >= 16


def _any(**_) -> bool:
    return True


def _conv_mma(N: int, M: int, S2: int, **_) -> bool:
    return N % 4 == 0 and _mma16(M) and S2 <= 4


def _conv_bw_mma(N: int, M: int, **_) -> bool:
    return N % 4 == 0 and _mma16(M)


_FEW_MAX_C = 186  # the few-channel forward's most packed positions (domain_engine.cu's kFewMaxC)

# The shapes each instantiation takes, as its source's ``*_takes`` case reads
# them: N and M the input and output channels, S the stride at the deconv
# corner, S2 the conv corner's phases, C the packed positions, M2 / N2 the
# outputs / positions a tile (4 / 16 in 2D, 2 / <= 16 at rank 1).  The
# tensor cores move weights and g rows in 16-byte copies, which is where
# ``_SIXTEEN_BYTE_COPIES`` holds their alignment.
SHAPE_CONDITIONS: dict[str, tuple[Callable[..., bool], ...]] = {
    "fused_engine": (_any, *[lambda M, S, **_: _mma16(M) and S <= 4] * 2),
    "fused_engine_bwd_x": (_any, lambda M, **_: M >= 8 and M % 4 == 0),
    "fused_engine_bwd_w": (_any, lambda M, **_: _mma16(M)),
    "conv_fused_engine": (_any, _conv_mma, _conv_mma),
    "conv_fused_engine_bwd_x": (_any, *[lambda M, **_: M >= 8 and M % 4 == 0] * 2),
    "conv_fused_engine_bwd_w": (_any, _conv_bw_mma, _conv_bw_mma, _conv_bw_mma),
    "domain_engine": (_any, lambda M, **_: _mma16(M), lambda C, **_: C <= _FEW_MAX_C),
    "domain_engine_bwd_x": (_any, lambda M, M2, **_: M >= 8 and M % 4 == 0 and M2 == 4,
                            lambda M, M2, N2, **_: M >= 8 and M % 4 == 0 and M2 == 2 and N2 <= 4,
                            lambda M, M2, N2, **_: M >= 8 and M % 4 == 0 and M2 == 2 and N2 > 4),
    "domain_engine_bwd_w": (_any, lambda M, M2, **_: _mma16(M) and M2 == 4,
                            *[lambda M, M2, **_: _mma16(M) and M2 == 2] * 2),
    "winograd_conv1d_fused_engine": (_any, *[lambda M, **_: _mma16(M)] * 2),
}


def _one(**_) -> int:
    return 1


def _n_chunks(N: int, M: int, **_) -> int:
    """The CUDA-core forwards' N chunks: 16 channels a chunk where their
    weights move in 16-byte copies, else 8."""
    return -(-N // (16 if M >= 32 and M % 4 == 0 else 8))


def _t_chunks(bt: int) -> Callable[..., int]:
    """A bwd_w's T chunks of ``bt`` tiles (T = the tiles), at most 65535."""
    return lambda T, **_: min(-(-T // bt), 65535)


# The most splits each instantiation runs at a shape (1: unsplit): the
# CUDA-core forwards' N chunks, the conv forward's tensor-core passes (at most
# 9 packed positions of one phase each), every bwd_w's T chunks of its BT
# tiles.
SPLIT_LIMITS: dict[str, tuple[Callable[..., int], ...]] = {
    "fused_engine": (_n_chunks, _one, _one),
    "fused_engine_bwd_x": (_one, _one),
    "fused_engine_bwd_w": (_t_chunks(4), _t_chunks(8)),
    "conv_fused_engine": (_one, *[lambda pos_idx, S2, **_: _conv_passes(tuple(pos_idx), S2)] * 2),
    "conv_fused_engine_bwd_x": (_one, _one, _one),
    "conv_fused_engine_bwd_w": (lambda N, T, **_: _t_chunks(4 if N % 4 == 0 else 8)(T=T), _t_chunks(16),
                                _t_chunks(8), _t_chunks(8)),
    "domain_engine": (_n_chunks, _one, _one),
    "domain_engine_bwd_x": (_one, _one, _one, _one),
    "domain_engine_bwd_w": (_t_chunks(4), _t_chunks(16), _t_chunks(16), _t_chunks(16)),
    "winograd_conv1d_fused_engine": (_one, _one, _one),
}


def _want(kernel: str, conf: str | None, splits: int | None) -> tuple[int, int]:
    """(want, want_splits) for ``kernel``'s C plan: the number of the
    instantiation ``conf`` names and the split count, -1 for the plan's own
    choice.  Raises ValueError for a name not in ``INSTANTIATIONS[kernel]``,
    a split without a ``conf`` or a count below 1; the shape is the plan's
    (or ``request``'s) to judge."""
    names = INSTANTIATIONS[kernel]
    if conf is None:
        if splits is not None:
            raise ValueError(f"{kernel}: splits={splits} needs conf, the instantiation it splits ({names})")
        return -1, -1
    if conf not in names:
        raise ValueError(f"{kernel} has no instantiation {conf!r}: one of {names}")
    if splits is None:
        return names.index(conf), -1
    if isinstance(splits, bool) or not isinstance(splits, int) or splits < 1:
        raise ValueError(f"{kernel}: splits must be a count >= 1, not {splits!r}")
    return names.index(conf), splits


def request(kernel: str, conf: str | None = None, splits: int | None = None, **shape) -> tuple[int, int]:
    """``_want`` checked against the table: also raises ValueError for an
    instantiation the ``shape`` (keywords as ``SHAPE_CONDITIONS`` and
    ``SPLIT_LIMITS`` read them) does not take, or a count past
    ``SPLIT_LIMITS``'s.  The CPU's check of what the C plans refuse."""
    k, want_splits = _want(kernel, conf, splits)
    if k < 0:
        return k, want_splits
    if not SHAPE_CONDITIONS[kernel][k](**shape):
        raise ValueError(f"{kernel}'s {conf} does not take {shape}")
    if want_splits > 0:
        most = SPLIT_LIMITS[kernel][k](**shape)
        if want_splits > most:
            raise ValueError(f"{kernel}'s {conf} runs 1 to {most} splits at {shape}, not {splits!r}")
    return k, want_splits


class Launch(NamedTuple):
    """One CUDA launch as ``launch_log`` records it: the wrapper, the shape
    keywords ``request`` reads, the instantiation's name and the split
    count that ran, and ``plan(want, want_splits)``: the C plan at this
    shape (raising ValueError where it refuses the request).  ``work``
    holds the keywords of the kernel's count in ``kernels/costs.py``
    (``costs.of_launch``)."""

    kernel: str
    shape: dict
    conf: str
    splits: int
    plan: Callable
    work: dict | None = None


launch_log: list[Launch] | None = None


def _log(kernel: str, shape: dict, k: int, splits: int, plan, *plan_args, work: dict | None = None) -> None:
    """Append the launch to ``launch_log``; a wrapper calls it only while
    the log is on (``if launch_log is not None``), so the main path builds
    no record."""
    launch_log.append(Launch(kernel, shape, INSTANTIATIONS[kernel][k], splits,
                             functools.partial(plan, *plan_args), work))


_INVALID_VALUE = 1  # cudaErrorInvalidValue: a plan's refusal of a request


def _plan_error(kernel: str, err: int, want: int, want_splits: int) -> Exception:
    """A C plan's nonzero return as an exception: its refusal of a request
    (an instantiation or split the shape cannot take) a ValueError, as
    ``request`` raises on the CPU; any other error a RuntimeError."""
    if err == _INVALID_VALUE and (want >= 0 or want_splits >= 1):
        conf = INSTANTIATIONS[kernel][want] if want >= 0 else "its own instantiation"
        return ValueError(f"{kernel}'s plan does not take {conf} with splits={want_splits} at this shape")
    return RuntimeError(f"{kernel} plan failed: cudaError {err}")


def _unsplit(kernel: str, want_splits: int) -> None:
    """The plans of the kernels that never split take a split of 1 only."""
    if want_splits > 1:
        raise ValueError(f"{kernel} runs 1 to 1 splits, not {want_splits}")



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


@functools.lru_cache(maxsize=None)
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
def _plan(B: int, ty: int, tx: int, N: int, M: int, S: int, device_index: int, want: int = -1,
          want_splits: int = -1):
    """(splits, scratch floats, counters, (BT, BM, the most packed positions
    a pass, conf)) of the kernel for this shape on this card, from the
    library's own choice, or of instantiation ``want`` with ``want_splits``
    (``_want``; a ValueError where it refuses them): conf 0 is the CUDA-core
    kernel (its N-loop split: splits, scratch and counters), 1 or 2 a
    tensor-core configuration (where its blocks fill the card; unsplit).
    The library also raises the
    configuration's shared-memory limit here, which every launch needs."""
    import ctypes

    from ._build import load_library

    splits, floats, counters, tile = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_longlong(), (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        err = load_library().fused_engine_plan(B, ty, tx, N, M, S, want, want_splits, device_index,
                                               ctypes.byref(splits), ctypes.byref(floats), ctypes.byref(counters),
                                               tile)
    if err != 0:
        raise _plan_error("fused_engine", err, want, want_splits)
    return splits.value, floats.value, counters.value, tuple(tile)


@functools.lru_cache(maxsize=None)  # a few hundred ints per (shape, stream); never freed under a launch
def _split_counters(n: int, device_index: int, stream: int) -> torch.Tensor:
    """The N-loop split's arrival counters, zeroed once: the kernel leaves
    them at 0.  One buffer per stream, since launches on one stream run in
    order and never share it at the same time."""
    return torch.zeros(n, dtype=torch.int32, device=torch.device("cuda", device_index))


def _m4(least: int):
    """(N, M) -> M % 4 == 0 and M >= least: where a kernel's configuration
    moves rows of M channels in 16-byte copies."""
    return lambda N, M: M % 4 == 0 and M >= least


# The operands each CUDA wrapper's kernel stages in 16-byte cp.async copies,
# each with the (N, M) where it does: the kernels' configuration choices
# (with_conf, mma_conf, with_fwd_conf, with_bx_conf, with_bw_conf in csrc/;
# the deconv corner's and the 1D engine's weights at M % 4 == 0 and M >=
# 16, where their tensor-core kernels take them on a grid that fills the
# card, held to that condition at any grid; the conv corner's at M >= 16
# where N % 4 == 0, its tensor-core kernel's, held at any stride).
# Elsewhere the kernel takes 4-byte copies (few or ragged channels).
_SIXTEEN_BYTE_COPIES = {
    "fused_engine": {"cells": lambda N, M: True, "ww_packed": _m4(16)},
    "fused_engine_bwd_x": {"g": _m4(8), "ww_packed": _m4(8)},
    "fused_engine_bwd_w": {"cells": lambda N, M: True, "g": _m4(16)},
    "conv_fused_engine": {"cells": lambda N, M: N % 4 == 0,
                          "ww_packed": lambda N, M: M % 4 == 0 and M >= (16 if N % 4 == 0 else 32)},
    "conv_fused_engine_bwd_x": {"g": _m4(8), "ww_packed": _m4(8)},
    "conv_fused_engine_bwd_w": {"cells": lambda N, M: N % 4 == 0, "g": _m4(16)},
    "domain_engine": {"xw": lambda N, M: True, "ww_packed": _m4(32)},
    "domain_engine_bwd_x": {"g": _m4(8), "ww_packed": _m4(8)},
    "domain_engine_bwd_w": {"xw": lambda N, M: True, "g": _m4(16)},
    "winograd_conv1d_fused_engine": {"cells": lambda N, M: True, "ww_packed": _m4(16)},
}


def _check_aligned(what: str, N: int, M: int, **operands: torch.Tensor) -> None:
    """The operands that ``what``'s kernel stages in 16-byte copies at
    (N, M) must start on a 16-byte boundary: a contiguous view at another
    offset (``buf[1:]``) would fault in the kernel and lose the process's
    CUDA context.  Refuse it before any launch; nothing copies the tensor or
    falls back."""
    moved = [name for name, when in _SIXTEEN_BYTE_COPIES[what].items() if when(N, M)]
    bad = [name for name in moved if operands[name].data_ptr() % 16]
    if bad:
        raise ValueError(f"{what} moves rows of {', '.join(moved)} in 16-byte copies at N={N}, M={M}: "
                         f"{', '.join(bad)} must start on a 16-byte boundary")


def _check_vec(name, v, M, device):
    if v is None:
        return None
    if v.device != device or v.dtype is not torch.float32 or v.shape != (M,) or not v.is_contiguous():
        raise ValueError(f"{name} must be a contiguous fp32 ({M},) tensor on {device}, got "
                         f"{tuple(v.shape)} {v.dtype} on {v.device}")
    return v


def _fwd_passes(pos_q: tuple[int, ...], subs: tuple[tuple[int, int], ...], pmax: int, smax: int):
    """The pass plan of the forward tensor-core kernel (csrc/fwd_core.cuh).

    ``pos_q``: each packed position's Winograd position (< 16); ``subs``:
    the fold groups' [lo, hi) ranges of packed positions (the 1D engine's
    sub-filters).  A pass holds consecutive positions, at most ``pmax`` of
    them (the shared memory of their operands) from at most ``smax`` fold
    groups (the outputs a thread holds); its distinct Winograd positions get
    slots in order of first use.  Returns (plan, npass, nslot, npos): plan =
    pass offsets (npass + 1), each pass's fold groups (npass x smax, -1 past
    the last), each position's index among them (C), its slot (C), each
    pass's Winograd position -> slot or -1 (npass x 16), as the kernel reads
    it (fwd::Plan); nslot / npos the most slots / positions of any pass."""
    sub_of = [s for s, (lo, hi) in enumerate(subs) for _ in range(lo, hi)]
    passes, a = [], 0
    for p in range(len(pos_q)):
        held = set(sub_of[a:p])
        if p > a and (p - a == pmax or (sub_of[p] not in held and len(held) == smax)):
            passes.append((a, p))
            a = p
    if len(pos_q) > a:
        passes.append((a, len(pos_q)))
    psub, isub, islot, qslot = [], [], [], []
    for a, b in passes:
        held = sorted(set(sub_of[a:b]))
        psub += held + [-1] * (smax - len(held))
        slots: dict[int, int] = {}
        for p in range(a, b):
            isub.append(held.index(sub_of[p]))
            islot.append(slots.setdefault(pos_q[p], len(slots)))
        qslot += [slots.get(q, -1) for q in range(16)]
    pass_off = [0] + [b for _, b in passes]
    nslot = max((len(set(pos_q[a:b])) for a, b in passes), default=0)
    npos = max((b - a for a, b in passes), default=0)
    return tuple(pass_off + psub + isub + islot + qslot), len(passes), nslot, npos


@functools.lru_cache(maxsize=64)
def _fwd_plan_tensor(pos_q: tuple[int, ...], subs: tuple[tuple[int, int], ...], pmax: int, smax: int, device: str):
    """``_fwd_passes`` with the plan as an int32 tensor on ``device``, built
    once per layer geometry and device."""
    plan, npass, nslot, npos = _fwd_passes(pos_q, subs, pmax, smax)
    return torch.tensor(plan, dtype=torch.int32, device=device), npass, nslot, npos


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
    conf: str | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """Epilogue-fused engine at the deconv corner (one input phase, stride S).

    Returns (B, out_h, out_w, M) in nhwc mode, (B, ty*S, tx*S, m*m, M) in
    cells mode with pixels outside the crop window zeroed, or the tile
    outputs (B, ty, tx, S*S*m*m, M) in scratch mode (no epilogue).  CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    takes F(2,3) only, fp32, contiguous inputs: on the tensor cores where
    the plan finds that their blocks fill the card, else on the CUDA cores
    (``_plan``), or on the instantiation ``conf`` names with ``splits`` N
    splits (refused with ValueError where the shape cannot take them)."""
    if out_mode not in _OUT_MODES:
        raise ValueError(f"out_mode {out_mode!r} not in {tuple(_OUT_MODES)}")
    if activation not in _ACT_CODES:
        raise ValueError(f"unsupported epilogue activation {activation!r}")
    if out_mode == "scratch" and (activation != "none" or scale is not None or bias is not None):
        raise ValueError("scratch mode has no epilogue: activation 'none', no scale, no bias")
    shape = dict(N=cells.shape[-1], M=ww_packed.shape[-1], S=stride)
    if cells.device.type == "cpu":
        request("fused_engine", conf, splits, **shape)
        return fused_engine_plain(
            cells, ww_packed, inv_packed, pos_idx=pos_idx, sub_slices=sub_slices, m=m, n=n,
            ty=ty, tx=tx, out_mode=out_mode, activation=activation, scale=scale, bias=bias,
            stride=stride, padding=padding, out_h=out_h, out_w=out_w,
        )
    if cells.device.type != "cuda":
        raise ValueError(f"fused_engine runs on cpu or cuda tensors, got {cells.device}")
    want = _want("fused_engine", conf, splits)

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
    _check_aligned("fused_engine", N, M, cells=cells, ww_packed=ww_packed)
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
    n_splits, n_scratch, n_counters, (_, _, pmax, k) = _plan(B, ty, tx, N, M, S, dev.index, *want)
    fplan, npass, nslot, npos = None, 0, 0, 0
    if k:  # the tensor cores: passes of one sub-filter each
        fplan, npass, nslot, npos = _fwd_plan_tensor(tuple(pos_idx), tuple(sub_slices), pmax, 1, str(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the N-loop split's partial products and arrival counters
    partial = torch.empty(n_scratch, dtype=torch.float32, device=dev) if n_scratch else None
    counters = _split_counters(n_counters, dev.index, stream) if n_counters else None
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    err = lib.fused_engine_epi_f32(
        cells.data_ptr(), ww_packed.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(),
        offs.data_ptr(), None if fplan is None else fplan.data_ptr(), None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        B, Gy, Gx, N, M, S, ty, tx, padding, out_h, out_w,
        _OUT_MODES[out_mode], _ACT_CODES[activation], k, C, npass, nslot, npos, n_splits,
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
    if launch_log is not None:
        _log("fused_engine", shape, k, n_splits, _plan, B, ty, tx, N, M, S, dev.index,
             work=dict(B=B, ty=ty, tx=tx, N=N, M=M, inv=inv_packed, sub_slices=tuple(sub_slices),
                       cells=cells.numel(), out=n_out, vectors=(scale is not None) + (bias is not None),
                       epilogue=out_mode != "scratch"))
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
    conf: str | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """dL/dcells (B, gy, gx, m*m, N) of the fused engine at the deconv
    corner: the exact shape of the forward's cells input, zero in rows and
    columns the forward never reads.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (F(2,3), fp32, contiguous inputs; g and
    ww_packed 16-byte aligned where M % 4 == 0) on the plan's instantiation
    or ``conf``'s (unsplit: ``splits`` None or 1)."""
    kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m=m, n=n, ty=ty, tx=tx, stride=stride)
    shape = dict(M=g.shape[-1])
    if g.device.type == "cpu":
        request("fused_engine_bwd_x", conf, splits, **shape)
        return fused_engine_bwd_x_plain(g, ww_packed, inv_packed, gy=gy, gx=gx, **kw)
    if g.device.type != "cuda":
        raise ValueError(f"fused_engine_bwd_x runs on cpu or cuda tensors, got {g.device}")
    want = _want("fused_engine_bwd_x", conf, splits)
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
    _check_aligned("fused_engine_bwd_x", N, M, g=g, ww_packed=ww_packed)

    from ._build import load_library

    dev = g.device
    lib = load_library()
    pos, offs = _layout_tensors(tuple(pos_idx), tuple(sub_slices), str(dev))
    R, W, TC, _, k = _bwd_x_plan(B, gy, gx, ty, tx, M, dev.index, *want)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    err = lib.fused_engine_bwd_x_f32(
        g.data_ptr(), ww_packed.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), offs.data_ptr(),
        out.data_ptr(), B, gy, gx, N, M, stride, ty, tx, R, W, TC, C, k,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_engine_bwd_x kernel launch failed: cudaError {err} (B={B}, cells {gy}x{gx}, "
                           f"tiles {ty}x{tx}, N={N}, M={M}, S={stride}, C={C}, plan {(R, W, TC)})")
    fused_engine_bwd_x.launches += 1
    if launch_log is not None:
        _log("fused_engine_bwd_x", shape, k, 1, _bwd_x_plan, B, gy, gx, ty, tx, M, dev.index,
             work=dict(B=B, ty=ty, tx=tx, gy=gy, gx=gx, N=N, M=M, inv=inv_packed, sub_slices=tuple(sub_slices)))
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
    conf: str | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """dL/dww (C, N, M) of the fused engine at the deconv corner, xw
    recomputed from the cells.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (F(2,3), fp32, contiguous, N % 4 == 0; cells
    16-byte aligned, and g where M % 4 == 0 and M >= 16) on the plan's
    instantiation and T split or ``conf``'s and ``splits``."""
    kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m=m, n=n, ty=ty, tx=tx, stride=stride)
    shape = dict(M=g.shape[-1], T=g.shape[0] * ty * tx)
    if g.device.type == "cpu":
        request("fused_engine_bwd_w", conf, splits, **shape)
        return fused_engine_bwd_w_plain(cells, g, inv_packed, **kw)
    if g.device.type != "cuda":
        raise ValueError(f"fused_engine_bwd_w runs on cpu or cuda tensors, got {g.device}")
    want = _want("fused_engine_bwd_w", conf, splits)
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
    _check_aligned("fused_engine_bwd_w", N, M, cells=cells, g=g)

    from ._build import load_library

    dev = g.device
    lib = load_library()
    pos, offs = _layout_tensors(tuple(pos_idx), tuple(sub_slices), str(dev))
    n_splits, n_scratch, n_counters, tile = _bwd_w_plan(B, ty, tx, N, M, stride, C, dev.index, *want)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = torch.empty(n_scratch, dtype=torch.float32, device=dev) if n_scratch else None
    counters = _split_counters(n_counters, dev.index, stream) if n_counters else None
    out = torch.empty((C, N, M), dtype=torch.float32, device=dev)
    err = lib.fused_engine_bwd_w_f32(
        cells.data_ptr(), g.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), offs.data_ptr(),
        out.data_ptr(), B, Gy, Gx, N, M, stride, ty, tx, C, tile[3], n_splits,
        None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_engine_bwd_w kernel launch failed: cudaError {err}")
    fused_engine_bwd_w.launches += 1
    if launch_log is not None:
        _log("fused_engine_bwd_w", shape, tile[3], n_splits, _bwd_w_plan, B, ty, tx, N, M, stride, C, dev.index,
             work=dict(B=B, ty=ty, tx=tx, N=N, M=M, inv=inv_packed, sub_slices=tuple(sub_slices),
                       cells=cells.numel()))
    return out


fused_engine_bwd_w.launches = 0


@functools.lru_cache(maxsize=256)
def _bwd_x_plan(B: int, gy: int, gx: int, ty: int, tx: int, M: int, device_index: int, want: int = -1,
                want_splits: int = -1):
    """(R, W, TC, BT, conf) of the bwd_x kernel's block geometry for this
    shape: R cell rows by W cell columns per block, TC tile columns per slot
    row, BT tile slots, on instantiation conf (the plan's, or ``want``).  The
    library raises the kernel's shared-memory limit here, once."""
    import ctypes

    from ._build import load_library

    _unsplit("fused_engine_bwd_x", want_splits)
    out = [ctypes.c_int() for _ in range(5)]
    with torch.cuda.device(device_index):
        err = load_library().fused_engine_bwd_x_plan(B, gy, gx, ty, tx, M, want, *map(ctypes.byref, out))
    if err != 0:
        raise _plan_error("fused_engine_bwd_x", err, want, want_splits)
    return tuple(v.value for v in out)


@functools.lru_cache(maxsize=256)
def _bwd_w_plan(B: int, ty: int, tx: int, N: int, M: int, S: int, C: int, device_index: int, want: int = -1,
                want_splits: int = -1):
    """(splits, scratch floats, counters, (BN, BM, BT, instantiation: 0 the
    CUDA cores, 1 the tensor cores)) of the bwd_w kernel for this shape on
    this card: its T-loop split and block tile, the plan's or ``want``'s with
    ``want_splits``.  The library raises the kernel's shared-memory limit
    here, once."""
    import ctypes

    from ._build import load_library

    splits, floats, counters, tile = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_longlong(), (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        err = load_library().fused_engine_bwd_w_plan(B, ty, tx, N, M, S, C, want, want_splits, device_index,
                                                     ctypes.byref(splits), ctypes.byref(floats),
                                                     ctypes.byref(counters), tile)
    if err != 0:
        raise _plan_error("fused_engine_bwd_w", err, want, want_splits)
    return splits.value, floats.value, counters.value, tuple(tile)


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
    conf: str | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """Epilogue-fused engine at the conv corner: returns (B, out_h, out_w, M)
    in nhwc mode, or (B, ty, tx, m*m, M) in cells mode with pixels outside
    [0, out_h) x [0, out_w) zeroed.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (F(2,3), fp32, contiguous inputs; on the
    tensor cores where N % 4 == 0, M % 4 == 0, M >= 16 and S <= 2, their
    passes split over blocks where the grid would leave SMs idle), or the
    instantiation ``conf`` names with ``splits`` pass splits."""
    if out_mode not in _OUT_MODES:
        raise ValueError(f"out_mode {out_mode!r} not in {tuple(_OUT_MODES)}")
    if activation not in _ACT_CODES:
        raise ValueError(f"unsupported epilogue activation {activation!r}")
    kw = dict(pos_idx=pos_idx, m=m, n=n, ty=ty, tx=tx, s2=s2)
    shape = dict(N=cells.shape[-1], M=ww_packed.shape[-1], S2=s2, pos_idx=tuple(pos_idx))
    if cells.device.type == "cpu":
        request("conv_fused_engine", conf, splits, **shape)
        return conv_fused_engine_plain(cells, ww_packed, inv_packed, out_mode=out_mode, activation=activation,
                                       scale=scale, bias=bias, out_h=out_h, out_w=out_w, **kw)
    if cells.device.type != "cuda":
        raise ValueError(f"conv_fused_engine runs on cpu or cuda tensors, got {cells.device}")
    want = _want("conv_fused_engine", conf, splits)
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
    _check_aligned("conv_fused_engine", N, M, cells=cells, ww_packed=ww_packed)
    pos, off = _conv_layout_tensors(tuple(pos_idx), s2, str(dev))

    from ._build import load_library

    lib = load_library()
    n_splits, n_scratch, n_counters, (fplan, npass, nslot, npos), k = _conv_fwd_plan(B, ty, tx, N, M, tuple(pos_idx),
                                                                                     s2, dev.index, *want)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the pass split's partial outputs and arrival counters
    partial = torch.empty(n_scratch, dtype=torch.float32, device=dev) if n_scratch else None
    counters = _split_counters(n_counters, dev.index, stream) if n_counters else None
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    err = lib.conv_engine_fwd_f32(
        cells.data_ptr(), ww_packed.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), off.data_ptr(),
        None if fplan is None else fplan.data_ptr(), None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), B, cells.shape[1], cells.shape[2], N, M, s2, ty,
        tx, out_h, out_w, _OUT_MODES[out_mode], _ACT_CODES[activation], C, k, npass, nslot, npos, n_splits,
        None if partial is None else partial.data_ptr(), None if counters is None else counters.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"conv_fused_engine kernel launch failed: cudaError {err}")
    conv_fused_engine.launches += 1
    if launch_log is not None:
        _log("conv_fused_engine", shape, k, n_splits, _conv_fwd_plan, B, ty, tx, N, M, tuple(pos_idx), s2,
             dev.index, work=dict(B=B, ty=ty, tx=tx, N=N, M=M, inv=inv_packed, s2=s2, cells=cells.numel(),
                                  out=out.numel(), vectors=(scale is not None) + (bias is not None)))
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
    conf: str | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """dL/dcells (B, gy, gx, s2*m*m, N) of the conv engine's products, zero
    in rows and columns the forward never reads.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (F(2,3), fp32, contiguous
    inputs; g and ww_packed 16-byte aligned where M % 4 == 0 and M >= 8) on
    the plan's instantiation or ``conf``'s (unsplit)."""
    kw = dict(pos_idx=pos_idx, m=m, n=n, ty=ty, tx=tx, s2=s2)
    shape = dict(N=ww_packed.shape[1], M=ww_packed.shape[-1])
    if g.device.type == "cpu":
        request("conv_fused_engine_bwd_x", conf, splits, **shape)
        return conv_fused_engine_bwd_x_plain(g, ww_packed, inv_packed, gy=gy, gx=gx, **kw)
    if g.device.type != "cuda":
        raise ValueError(f"conv_fused_engine_bwd_x runs on cpu or cuda tensors, got {g.device}")
    want = _want("conv_fused_engine_bwd_x", conf, splits)
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
    _check_aligned("conv_fused_engine_bwd_x", N, M, g=g, ww_packed=ww_packed)
    pos, off = _conv_layout_tensors(tuple(pos_idx), s2, str(dev))

    from ._build import load_library

    lib = load_library()
    R, W, TC, tile = _conv_bwd_x_plan(B, gy, gx, ty, tx, N, M, dev.index, *want)
    out = torch.empty((B, gy, gx, s2 * m * m, N), dtype=torch.float32, device=dev)
    err = lib.conv_engine_bwd_x_f32(
        g.data_ptr(), ww_packed.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), off.data_ptr(),
        out.data_ptr(), B, gy, gx, N, M, s2, ty, tx, R, W, TC, tile[2], torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"conv_fused_engine_bwd_x kernel launch failed: cudaError {err}")
    conv_fused_engine_bwd_x.launches += 1
    if launch_log is not None:
        _log("conv_fused_engine_bwd_x", shape, tile[2], 1, _conv_bwd_x_plan, B, gy, gx, ty, tx, N, M, dev.index,
             work=dict(B=B, ty=ty, tx=tx, gy=gy, gx=gx, N=N, M=M, inv=inv_packed, s2=s2))
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
    conf: str | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """dL/dww (C, N, M) of the conv engine's products, xw recomputed from
    the cells.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (F(2,3), fp32, contiguous inputs; cells 16-byte aligned where N %
    4 == 0, and g where M % 4 == 0 and M >= 16) on the plan's instantiation
    and T split or ``conf``'s and ``splits``."""
    kw = dict(pos_idx=pos_idx, m=m, n=n, ty=ty, tx=tx, s2=s2)
    shape = dict(N=cells.shape[-1], M=g.shape[-1], T=g.shape[0] * ty * tx)
    if g.device.type == "cpu":
        request("conv_fused_engine_bwd_w", conf, splits, **shape)
        return conv_fused_engine_bwd_w_plain(cells, g, inv_packed, **kw)
    if g.device.type != "cuda":
        raise ValueError(f"conv_fused_engine_bwd_w runs on cpu or cuda tensors, got {g.device}")
    want = _want("conv_fused_engine_bwd_w", conf, splits)
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
    _check_aligned("conv_fused_engine_bwd_w", N, M, cells=cells, g=g)
    pos, off = _conv_layout_tensors(tuple(pos_idx), s2, str(dev))

    from ._build import load_library

    lib = load_library()
    n_splits, n_scratch, n_counters, tile = _conv_bwd_w_plan(B, ty, tx, N, M, s2, C, dev.index, *want)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = torch.empty(n_scratch, dtype=torch.float32, device=dev) if n_scratch else None
    counters = _split_counters(n_counters, dev.index, stream) if n_counters else None
    out = torch.empty((C, N, M), dtype=torch.float32, device=dev)
    err = lib.conv_engine_bwd_w_f32(
        cells.data_ptr(), g.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), off.data_ptr(), out.data_ptr(),
        B, cells.shape[1], cells.shape[2], N, M, s2, ty, tx, C, tile[3], n_splits,
        None if partial is None else partial.data_ptr(), None if counters is None else counters.data_ptr(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"conv_fused_engine_bwd_w kernel launch failed: cudaError {err}")
    conv_fused_engine_bwd_w.launches += 1
    if launch_log is not None:
        _log("conv_fused_engine_bwd_w", shape, tile[3], n_splits, _conv_bwd_w_plan, B, ty, tx, N, M, s2, C,
             dev.index, work=dict(B=B, ty=ty, tx=tx, N=N, M=M, inv=inv_packed, s2=s2, cells=cells.numel()))
    return out


conv_fused_engine_bwd_w.launches = 0


def _conv_fwd_conf(N: int, M: int, s2: int, want: int = -1, want_splits: int = -1):
    """(BT, BM, the most packed positions a pass, instantiation: 0 the CUDA
    cores, 1 or 2 the tensor cores) of the conv forward kernel's block
    configuration for (N, M, S^2): the plan's, or ``want``."""
    import ctypes

    from ._build import load_library

    tile = (ctypes.c_int * 4)()
    err = load_library().conv_engine_fwd_conf(N, M, s2, want, tile)
    if err != 0:
        raise _plan_error("conv_fused_engine", err, want, want_splits)
    return tuple(tile)


_CONV_MMA_PMAX = 9  # the conv forward's tensor-core passes: at most 9 packed positions (one K4S2 phase)


def _conv_pass_groups(pos_idx: tuple[int, ...], s2: int):
    """(each packed position's Winograd position, each phase's [lo, hi)
    packed positions): the conv forward's tensor-core pass groups, a phase
    each."""
    off = [sum(p // 16 < s for p in pos_idx) for s in range(s2 + 1)]
    return tuple(p % 16 for p in pos_idx), tuple(zip(off[:-1], off[1:]))


@functools.lru_cache(maxsize=256)
def _conv_passes(pos_idx: tuple[int, ...], s2: int) -> int:
    """The conv forward's tensor-core passes: the most ways its pass split
    runs."""
    return _fwd_passes(*_conv_pass_groups(pos_idx, s2), _CONV_MMA_PMAX, 1)[1]


@functools.lru_cache(maxsize=256)
def _conv_fwd_plan(B: int, ty: int, tx: int, N: int, M: int, pos_idx: tuple[int, ...], s2: int, device_index: int,
                   want: int = -1, want_splits: int = -1):
    """(splits, scratch floats, counters, (pass plan tensor or None, npass,
    nslot, npos), instantiation) of the conv forward kernel for this shape
    on this card, the plan's or ``want``'s with ``want_splits``: on the
    tensor cores its passes (at most the configuration's positions of one
    phase each) and their split over blocks, which the library sizes from
    this plan's own shared memory.  The library raises the kernel's
    shared-memory limit here, once."""
    import ctypes

    from ._build import load_library

    _, _, pmax, k = _conv_fwd_conf(N, M, s2, want, want_splits)
    fplan, npass, nslot, npos = None, 0, 0, 0
    if k:  # the phases are the passes' groups: a pass holds positions of one phase
        fplan, npass, nslot, npos = _fwd_plan_tensor(*_conv_pass_groups(pos_idx, s2), pmax, 1, f"cuda:{device_index}")
    splits, floats, counters = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_longlong()
    with torch.cuda.device(device_index):
        err = load_library().conv_engine_fwd_plan(B, ty, tx, N, M, s2, len(pos_idx), npass, nslot, npos, k,
                                                  want_splits, device_index, ctypes.byref(splits),
                                                  ctypes.byref(floats), ctypes.byref(counters))
    if err != 0:
        raise _plan_error("conv_fused_engine", err, want, want_splits)
    return splits.value, floats.value, counters.value, (fplan, npass, nslot, npos), k


@functools.lru_cache(maxsize=256)
def _conv_bwd_x_plan(B: int, gy: int, gx: int, ty: int, tx: int, N: int, M: int, device_index: int,
                     want: int = -1, want_splits: int = -1):
    """(R, W, TC, (BT, BN, instantiation: 0 the CUDA cores, 1 or 2 the
    tensor cores)) of the conv bwd_x kernel's block geometry for this shape,
    the plan's or ``want``'s: R cell rows by W cell columns per block, TC
    tile columns per slot row, BT tile slots by BN channels.  The library
    raises the kernel's shared-memory limit here, once."""
    import ctypes

    from ._build import load_library

    _unsplit("conv_fused_engine_bwd_x", want_splits)
    out, tile = [ctypes.c_int() for _ in range(3)], (ctypes.c_int * 3)()
    with torch.cuda.device(device_index):
        err = load_library().conv_engine_bwd_x_plan(B, gy, gx, ty, tx, N, M, want, *map(ctypes.byref, out), tile)
    if err != 0:
        raise _plan_error("conv_fused_engine_bwd_x", err, want, want_splits)
    return (*(v.value for v in out), tuple(tile))


@functools.lru_cache(maxsize=256)
def _conv_bwd_w_plan(B: int, ty: int, tx: int, N: int, M: int, s2: int, C: int, device_index: int, want: int = -1,
                     want_splits: int = -1):
    """(splits, scratch floats, counters, (BN, BM, BT, instantiation: 0 the
    CUDA cores, 1-3 the tensor cores)) of the conv bwd_w kernel for this
    shape on this card: its T-loop split and block tile, the plan's or
    ``want``'s with ``want_splits``.  The library raises the kernel's
    shared-memory limit here, once."""
    import ctypes

    from ._build import load_library

    splits, floats, counters, tile = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_longlong(), (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        err = load_library().conv_engine_bwd_w_plan(B, ty, tx, N, M, s2, C, want, want_splits, device_index,
                                                    ctypes.byref(splits), ctypes.byref(floats),
                                                    ctypes.byref(counters), tile)
    if err != 0:
        raise _plan_error("conv_fused_engine_bwd_w", err, want, want_splits)
    return splits.value, floats.value, counters.value, tuple(tile)


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


def _check_layout(tensors, *, pos_idx, sub_slices, n_pos, extents, sizes):
    """The checks every packed kernel shares: ``tensors`` contiguous fp32 on
    one device, 1..16 sub-filter slices tiling [0, C) in order, each
    sub-filter's positions distinct and in [0, n_pos), no empty extent and
    no size past 32-bit indices.  Returns (device, S2).  Raises: nothing
    falls back."""
    dev = tensors[0][1].device
    for name, t in tensors:
        if t.device != dev or t.dtype is not torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 tensor on {dev}, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    s2, C = len(sub_slices), len(pos_idx)
    if not 1 <= s2 <= 16 or sub_slices[0][0] != 0 or sub_slices[-1][1] != C or \
            any(sub_slices[i][1] != sub_slices[i + 1][0] for i in range(s2 - 1)):
        raise ValueError(f"sub_slices {sub_slices} must be 1..16 slices tiling [0, {C}) in order")
    for lo, hi in sub_slices:
        sub = pos_idx[lo:hi]
        if len(set(sub)) != len(sub) or any(not 0 <= p < n_pos for p in sub):
            raise ValueError(f"sub-filter positions {sub} must be distinct, in [0, {n_pos})")
    if min(extents) <= 0:
        raise ValueError("empty problem")
    if max(sizes) >= 2**31:
        raise ValueError("problem too large for the kernels' 32-bit indices")
    return dev, s2


def _check_domain(tensors, *, pos_idx, sub_slices, m2, T, N, M, n2=16, ranks=(4,)):
    """The checks the three unfused kernels share: ``_check_layout`` and
    the transform.  The kernels take F(2x2, 3x3) (m2 = 4 outputs and n2 =
    16 positions per tile) and, where ``ranks`` holds 2, the 1D engine's
    F(2, r) (m2 = 2, n2 <= 16 positions: phases*n).  Returns (device, S^2)."""
    if m2 not in ranks:
        raise ValueError(f"the CUDA kernel takes m2 in {ranks} (F(2x2,3x3){' or 1D F(2,r)' if 2 in ranks else ''}), "
                         f"got m2={m2}")
    if (m2 == 4 and n2 != 16) or not 1 <= n2 <= 16:
        raise ValueError(f"n2={n2} Winograd positions per tile: 16 for m2=4, at most 16 for m2=2")
    s2, C = len(sub_slices), len(pos_idx)
    return _check_layout(tensors, pos_idx=pos_idx, sub_slices=sub_slices, n_pos=n2, extents=(T, N, M),
                         sizes=(T * n2 * N, T * s2 * m2 * M, C * N * M))


def _check_packed(ww_packed, inv_packed, C, N=None, M=None, m2=4):
    if ww_packed is not None and (ww_packed.dim() != 3 or ww_packed.shape[0] != C
                                  or (N is not None and ww_packed.shape[1] != N)
                                  or (M is not None and ww_packed.shape[2] != M)):
        raise ValueError(f"ww_packed must be ({C}, {N or 'N'}, {M or 'M'}), got {tuple(ww_packed.shape)}")
    if inv_packed.shape != (C, m2):
        raise ValueError(f"inv_packed must be ({C}, {m2}), got {tuple(inv_packed.shape)}")


def domain_engine(
    xw: torch.Tensor,  # (T, n*n, N) transformed input tiles
    ww_packed: torch.Tensor,  # (C, N, M)
    inv_packed: torch.Tensor,  # (C, m*m) fp32
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m2: int,
    conf: str | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """The unfused engine: the (T, S*S*m*m, M) tile outputs of every
    sub-filter, sub-filter-major.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (F(2,3), fp32, contiguous, N % 4 == 0) on the
    instantiation ``_domain_plan`` picks: the tensor cores (wgmma, after the
    weight pack), few channels, or the CUDA cores; or on the one ``conf``
    names, with ``splits`` N splits on the CUDA cores."""
    kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m2=m2)
    shape = dict(N=xw.shape[-1], M=ww_packed.shape[-1], C=len(pos_idx))
    if xw.device.type == "cpu":
        request("domain_engine", conf, splits, **shape)
        return domain_engine_plain(xw, ww_packed, inv_packed, **kw)
    if xw.device.type != "cuda":
        raise ValueError(f"domain_engine runs on cpu or cuda tensors, got {xw.device}")
    want = _want("domain_engine", conf, splits)
    return _domain_fwd(xw, ww_packed, inv_packed, want=want, **kw)


def _domain_fwd(xw, ww_packed, inv_packed, *, pos_idx, sub_slices, m2, want=(-1, -1)):
    """``domain_engine`` on CUDA tensors: check, plan, launch, count, on
    instantiation and split ``want`` (``_want``'s)."""
    kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m2=m2)
    if xw.dim() != 3 or xw.shape[1] != 16 or ww_packed.dim() != 3:
        raise ValueError(f"xw must be (T, 16, N) and ww_packed (C, N, M), got {tuple(xw.shape)}, "
                         f"{tuple(ww_packed.shape)}")
    T, _, N = xw.shape
    M, C = ww_packed.shape[2], len(pos_idx)
    dev, s2 = _check_domain((("xw", xw), ("ww_packed", ww_packed), ("inv_packed", inv_packed)), T=T, N=N, M=M,
                            **kw)
    _check_packed(ww_packed, inv_packed, C, N)
    if N % 4:
        raise ValueError(f"the CUDA kernel moves xw in 16-byte copies: N={N} must be a multiple of 4")
    _check_aligned("domain_engine", N, M, xw=xw, ww_packed=ww_packed)

    from ._build import load_library

    lib = load_library()
    pos, offs = _layout_tensors(tuple(pos_idx), tuple(sub_slices), str(dev))
    n_splits, n_scratch, n_counters, (_, _, k, _) = _domain_plan("fwd", T, N, M, s2, dev.index, 4, C, *want)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev) if n_scratch else None
    counters = _split_counters(n_counters, dev.index, stream) if n_counters else None
    out = torch.empty((T, s2 * 4, M), dtype=torch.float32, device=dev)
    err = lib.domain_engine_fwd_f32(
        xw.data_ptr(), ww_packed.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), offs.data_ptr(),
        out.data_ptr(), T, N, M, s2, C, k, n_splits,
        None if scratch is None else scratch.data_ptr(), None if counters is None else counters.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"domain_engine kernel launch failed: cudaError {err}")
    domain_engine.launches += 1
    if launch_log is not None:
        _log("domain_engine", dict(N=N, M=M, C=C), k, n_splits, _domain_plan, "fwd", T, N, M, s2, dev.index, 4, C,
             work=dict(T=T, n2=16, N=N, M=M, m2=m2, inv=inv_packed, sub_slices=tuple(sub_slices)))
    return out


domain_engine.launches = 0


def domain_engine_bwd_x(
    g: torch.Tensor,  # (T, S2*m2, M) cotangent of the tile outputs
    ww_packed: torch.Tensor,  # (C, N, M)
    inv_packed: torch.Tensor,  # (C, m2) fp32
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m2: int,
    n2: int,
    conf: str | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """dL/dxw (T, n2, N) of the unfused engine, zero at the Winograd
    positions no packed position keeps.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (fp32, contiguous, g and
    ww_packed 16-byte aligned where M % 4 == 0; F(2x2,3x3), m2 = 4 and
    n2 = 16, or the 1D engine's m2 = 2 and n2 <= 16) on the plan's
    instantiation or ``conf``'s (unsplit).
    ``.launches`` counts the 2D launches, ``.rank1_launches`` the 1D ones."""
    kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m2=m2)
    shape = dict(M=g.shape[-1], M2=m2, N2=n2)
    if g.device.type == "cpu":
        request("domain_engine_bwd_x", conf, splits, **shape)
        return domain_engine_bwd_x_plain(g, ww_packed, inv_packed, n2=n2, **kw)
    if g.device.type != "cuda":
        raise ValueError(f"domain_engine_bwd_x runs on cpu or cuda tensors, got {g.device}")
    want = _want("domain_engine_bwd_x", conf, splits)
    if g.dim() != 3 or g.shape[1] != len(sub_slices) * m2 or ww_packed.dim() != 3:
        raise ValueError(f"g must be (T, {len(sub_slices) * m2}, M) and ww_packed (C, N, M), got "
                         f"{tuple(g.shape)}, {tuple(ww_packed.shape)}")
    T, _, M = g.shape
    N = ww_packed.shape[1]
    dev, s2 = _check_domain((("g", g), ("ww_packed", ww_packed), ("inv_packed", inv_packed)), T=T, N=N, M=M,
                            n2=n2, ranks=(2, 4), **kw)
    _check_packed(ww_packed, inv_packed, len(pos_idx), N, M, m2)
    _check_aligned("domain_engine_bwd_x", N, M, g=g, ww_packed=ww_packed)

    from ._build import load_library

    lib = load_library()
    pos, offs = _layout_tensors(tuple(pos_idx), tuple(sub_slices), str(dev))
    k = _domain_bwd_x_plan(M, m2, n2, dev.index, *want)
    out = torch.empty((T, n2, N), dtype=torch.float32, device=dev)
    err = lib.domain_engine_bwd_x_f32(
        g.data_ptr(), ww_packed.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), offs.data_ptr(),
        out.data_ptr(), T, N, M, s2, m2, n2, len(pos_idx), k, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"domain_engine_bwd_x kernel launch failed: cudaError {err}")
    if m2 == 2:
        domain_engine_bwd_x.rank1_launches += 1
    else:
        domain_engine_bwd_x.launches += 1
    if launch_log is not None:
        _log("domain_engine_bwd_x", shape, k, 1, _domain_bwd_x_plan, M, m2, n2, dev.index,
             work=dict(T=T, n2=n2, N=N, M=M, m2=m2, inv=inv_packed, sub_slices=tuple(sub_slices)))
    return out


domain_engine_bwd_x.launches = 0
domain_engine_bwd_x.rank1_launches = 0


def domain_engine_bwd_w(
    xw: torch.Tensor,  # (T, n2, N) the forward's transformed tiles
    g: torch.Tensor,  # (T, S2*m2, M)
    inv_packed: torch.Tensor,  # (C, m2) fp32
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m2: int,
    conf: str | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """dL/dww (C, N, M) of the unfused engine.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (fp32, contiguous, N % 4 == 0;
    F(2x2,3x3) with xw (T, 16, N), or the 1D engine's m2 = 2 with xw
    (T, n2 <= 16, N); xw 16-byte aligned, and g where M % 4 == 0 and M >=
    16) on the plan's instantiation and T split or ``conf``'s and
    ``splits``.  ``.launches`` counts the 2D launches,
    ``.rank1_launches`` the 1D ones."""
    kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m2=m2)
    shape = dict(N=xw.shape[-1], M=g.shape[-1], M2=m2, T=xw.shape[0])
    if g.device.type == "cpu":
        request("domain_engine_bwd_w", conf, splits, **shape)
        return domain_engine_bwd_w_plain(xw, g, inv_packed, **kw)
    if g.device.type != "cuda":
        raise ValueError(f"domain_engine_bwd_w runs on cpu or cuda tensors, got {g.device}")
    want = _want("domain_engine_bwd_w", conf, splits)
    if xw.dim() != 3 or g.dim() != 3 or g.shape[0] != xw.shape[0] or g.shape[1] != len(sub_slices) * m2:
        raise ValueError(f"xw must be (T, n2, N) and g (T, {len(sub_slices) * m2}, M), got {tuple(xw.shape)}, "
                         f"{tuple(g.shape)}")
    T, n2, N = xw.shape
    M = g.shape[2]
    dev, s2 = _check_domain((("g", g), ("xw", xw), ("inv_packed", inv_packed)), T=T, N=N, M=M, n2=n2,
                            ranks=(2, 4), **kw)
    _check_packed(None, inv_packed, len(pos_idx), m2=m2)
    if N % 4:
        raise ValueError(f"the CUDA kernel moves xw in 16-byte copies: N={N} must be a multiple of 4")
    _check_aligned("domain_engine_bwd_w", N, M, xw=xw, g=g)

    from ._build import load_library

    lib = load_library()
    C = len(pos_idx)
    pos, offs = _layout_tensors(tuple(pos_idx), tuple(sub_slices), str(dev))
    n_splits, n_scratch, n_counters, tile = _domain_plan("bwd_w", T, N, M, s2, dev.index, m2, C, *want)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = torch.empty(n_scratch, dtype=torch.float32, device=dev) if n_scratch else None
    counters = _split_counters(n_counters, dev.index, stream) if n_counters else None
    out = torch.empty((C, N, M), dtype=torch.float32, device=dev)
    err = lib.domain_engine_bwd_w_f32(
        xw.data_ptr(), g.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), offs.data_ptr(), out.data_ptr(),
        T, N, M, s2, m2, n2, C, tile[3], n_splits, None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"domain_engine_bwd_w kernel launch failed: cudaError {err}")
    if m2 == 2:
        domain_engine_bwd_w.rank1_launches += 1
    else:
        domain_engine_bwd_w.launches += 1
    if launch_log is not None:
        _log("domain_engine_bwd_w", shape, tile[3], n_splits, _domain_plan, "bwd_w", T, N, M, s2, dev.index, m2, C,
             work=dict(T=T, n2=n2, N=N, M=M, m2=m2, inv=inv_packed, sub_slices=tuple(sub_slices)))
    return out


domain_engine_bwd_w.launches = 0
domain_engine_bwd_w.rank1_launches = 0


@functools.lru_cache(maxsize=256)
def _domain_plan(which: str, T: int, N: int, M: int, s2: int, device_index: int, m2: int = 4, C: int = 0,
                 want: int = -1, want_splits: int = -1):
    """(splits, scratch floats, counters, tile) of an unfused kernel for
    this shape on this card, with C packed positions: the forward's
    instantiation and launch, tile (BT, BM, conf, 0) with conf 0 the CUDA
    cores (and their N split), 1 the tensor cores (scratch: the packed
    weights), 2 few channels; or bwd_w's T split and block tile (BN, BM, BT,
    instantiation: 0 the CUDA cores, 1-3 the tensor cores), with its m2
    outputs per tile.  ``want`` >= 0 asks for an instantiation and
    ``want_splits`` >= 1 for a split (``_want``; a ValueError where it
    refuses them).  The library raises the kernel's shared-memory limit
    here, once."""
    import ctypes

    from ._build import load_library

    splits, floats, counters, tile = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_longlong(), (ctypes.c_int * 4)()
    fn = getattr(load_library(), f"domain_engine_{which}_plan")
    shape = (C,) if which == "fwd" else (m2, C)
    with torch.cuda.device(device_index):
        err = fn(T, N, M, s2, *shape, want, want_splits, device_index, ctypes.byref(splits), ctypes.byref(floats),
                 ctypes.byref(counters), tile)
    if err != 0:
        raise _plan_error("domain_engine" if which == "fwd" else "domain_engine_bwd_w", err, want, want_splits)
    return splits.value, floats.value, counters.value, tuple(tile)


@functools.lru_cache(maxsize=64)
def _domain_bwd_x_plan(M: int, m2: int, n2: int, device_index: int, want: int = -1, want_splits: int = -1) -> int:
    """The unfused bwd_x kernel's instantiation for (M, m2, n2), the plan's
    or ``want``; raises its shared-memory limit, once per device."""
    import ctypes

    from ._build import load_library

    _unsplit("domain_engine_bwd_x", want_splits)
    conf = ctypes.c_int()
    with torch.cuda.device(device_index):
        err = load_library().domain_engine_bwd_x_plan(M, m2, n2, want, ctypes.byref(conf))
    if err != 0:
        raise _plan_error("domain_engine_bwd_x", err, want, want_splits)
    return conf.value


# ------------------------------------------------------------- 1D engine
_OUT_MODES_1D = {"scratch": 0, "nlc": 1}


def winograd_conv1d_fused_engine_plain(
    cells: torch.Tensor,
    ww_packed: torch.Tensor,
    inv_packed: torch.Tensor,
    bt_mat,
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m: int,
    n: int,
    ty: int,
    phases: int = 1,
    out_mode: str = "nlc",
    activation: str = "none",
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    stride: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version of the 1D kernel, on any device: the
    reference's ``conv1d_engine_ref`` then the epilogue (nlc), or its
    scratch counterpart ``conv1d_pre_engine_ref``."""
    kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m=m, n=n, ty=ty, phases=phases)
    if out_mode == "scratch":
        return _ref.conv1d_pre_engine_ref(cells, ww_packed, inv_packed, bt_mat, **kw)
    y = _ref.conv1d_engine_ref(cells, ww_packed, inv_packed, bt_mat, stride=stride, **kw)
    return epilogue_apply_ref(y, scale, bias, activation).to(cells.dtype)


def _bt_1d(bt_mat, m: int, n: int, device) -> torch.Tensor:
    """The layout's B^T as F(m, n - m + 1)'s fp32 (n, n) tensor on
    ``device``, cached there; raises for any other matrix."""
    if tuple(tuple(float(v) for v in row) for row in bt_mat) != _bt(m, n):
        raise ValueError(f"B^T must be the {n}x{n} matrix of F({m},{n - m + 1})")
    return _bt_on(m, n - m + 1, torch.float32, str(device))


def _check_engine1d(cells, ww_packed, inv_packed, bt_mat, *, pos_idx, sub_slices, m, n, ty, phases, out_mode,
                    stride, scale, bias):
    """What the 1D kernel takes; raises on anything else (nothing falls
    back).  Returns the output shape and B^T on the cells' device."""
    if m != 2 or n not in (4, 5):
        raise ValueError(f"the CUDA kernel takes F(2,3) and F(2,4) (m=2, n=4 or 5), got m={m}, n={n}")
    if not 1 <= phases <= 3 or phases * n > 16:
        raise ValueError(f"phases={phases}: the kernel takes 1..3 phases of at most 16 positions in all")
    if cells.dim() != 4 or cells.shape[2] != phases * m:
        raise ValueError(f"cells must be (B, Gy, {phases * m}, N), got {tuple(cells.shape)}")
    B, Gy, _, N = cells.shape
    C, S2 = len(pos_idx), len(sub_slices)
    if ww_packed.dim() != 3 or ww_packed.shape[:2] != (C, N) or inv_packed.shape != (C, m) or C > 16:
        raise ValueError(f"ww_packed {tuple(ww_packed.shape)} / inv_packed {tuple(inv_packed.shape)} do not hold "
                         f"C={C} <= 16 positions of {N} channels")
    M = ww_packed.shape[2]
    dev, _ = _check_layout((("cells", cells), ("ww_packed", ww_packed), ("inv_packed", inv_packed)),
                           pos_idx=pos_idx, sub_slices=sub_slices, n_pos=phases * n, extents=(B, Gy, N, M, ty),
                           sizes=(cells.numel(), ww_packed.numel(), B * ty * S2 * m * M))
    if out_mode == "nlc" and stride != S2:
        raise ValueError(f"nlc interleaves the sub-filters: stride {stride} must equal their count {S2}")
    if N % 4:
        raise ValueError(f"the CUDA kernel moves cell rows and weights in 16-byte copies: N={N} must be a "
                         f"multiple of 4")
    _check_aligned("winograd_conv1d_fused_engine", N, M, cells=cells, ww_packed=ww_packed)
    _check_vec("scale", scale, M, dev)
    _check_vec("bias", bias, M, dev)
    out_shape = (B, ty, S2 * m, M) if out_mode == "scratch" else (B, ty * m * stride, M)
    return out_shape, _bt_1d(bt_mat, m, n, dev)


def winograd_conv1d_fused_engine(
    cells: torch.Tensor,  # (B, Gy, phases*m, N) space-to-depth padded sequence
    ww_packed: torch.Tensor,  # (C, N, M)
    inv_packed: torch.Tensor,  # (C, m) fp32
    bt_mat: tuple[tuple[float, ...], ...],  # B^T (n, n)
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m: int,
    n: int,
    ty: int,
    phases: int = 1,
    out_mode: str = "nlc",  # "scratch" | "nlc"
    activation: str = "none",
    scale: torch.Tensor | None = None,  # (M,) per-channel epilogue scale
    bias: torch.Tensor | None = None,  # (M,) per-channel epilogue bias
    stride: int = 1,  # S, the nlc interleave factor
    conf: str | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """The 1D engine (the reference's ``winograd_conv1d_fused_engine``).

    Stride-1 conv1d (``phases=1, stride=1``, one sub-filter over all n
    positions), phase-decomposed strided conv1d (``phases=S``, its phases'
    positions in one sub-filter), and TDC deconv1d (``phases=1, stride=S``,
    S sub-filters interleaving); causal or SAME padding is in the caller's
    cells.  ``"scratch"`` returns (B, ty, S2*m, M); ``"nlc"`` applies
    act(scale * y + bias) and returns the padded interleave (B, ty*m*S, M),
    whose rows [P, P + L_O) are the output sequence.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (F(2,3) or F(2,4), fp32,
    contiguous, N % 4 == 0) on the plan's instantiation or ``conf``'s
    (unsplit)."""
    if out_mode not in _OUT_MODES_1D:
        raise ValueError(f"out_mode {out_mode!r} not in {tuple(_OUT_MODES_1D)}")
    if activation not in _ACT_CODES:
        raise ValueError(f"unsupported epilogue activation {activation!r}")
    if out_mode == "scratch" and (activation != "none" or scale is not None or bias is not None):
        raise ValueError("scratch mode has no epilogue: activation 'none', no scale, no bias")
    if stride <= 0:
        raise ValueError(f"stride {stride} must be >= 1")
    kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m=m, n=n, ty=ty, phases=phases, out_mode=out_mode)
    shape = dict(M=ww_packed.shape[-1])
    if cells.device.type == "cpu":
        request("winograd_conv1d_fused_engine", conf, splits, **shape)
        return winograd_conv1d_fused_engine_plain(cells, ww_packed, inv_packed, bt_mat, activation=activation,
                                                  scale=scale, bias=bias, stride=stride, **kw)
    if cells.device.type != "cuda":
        raise ValueError(f"winograd_conv1d_fused_engine runs on cpu or cuda tensors, got {cells.device}")
    want = _want("winograd_conv1d_fused_engine", conf, splits)
    out_shape, bt = _check_engine1d(cells, ww_packed, inv_packed, bt_mat, stride=stride, scale=scale, bias=bias,
                                    **kw)
    B, Gy, _, N = cells.shape
    M = ww_packed.shape[2]
    dev = cells.device

    from ._build import load_library

    lib = load_library()
    pos, offs = _layout_tensors(tuple(pos_idx), tuple(sub_slices), str(dev))
    _, _, pmax, smax, k = _engine1d_plan(B, ty, M, dev.index, *want)
    C = len(pos_idx)
    fplan, npass, nslot, npos = None, 0, 0, 0
    if k:
        fplan, npass, nslot, npos = _fwd_plan_tensor(tuple(pos_idx), tuple(sub_slices), pmax, smax, str(dev))
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    err = lib.engine1d_f32(
        cells.data_ptr(), ww_packed.data_ptr(), inv_packed.data_ptr(), pos.data_ptr(), offs.data_ptr(),
        bt.data_ptr(), None if fplan is None else fplan.data_ptr(), None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), B, Gy, N, M, ty, n, phases, len(sub_slices),
        stride, C, _OUT_MODES_1D[out_mode], _ACT_CODES[activation], k, npass, nslot, npos,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"winograd_conv1d_fused_engine kernel launch failed: cudaError {err}")
    if out_mode == "scratch":
        winograd_conv1d_fused_engine.scratch_launches += 1
    else:
        winograd_conv1d_fused_engine.launches += 1
    if launch_log is not None:
        _log("winograd_conv1d_fused_engine", shape, k, 1, _engine1d_plan, B, ty, M, dev.index,
             work=dict(B=B, ty=ty, N=N, M=M, phases=phases, inv=inv_packed, sub_slices=tuple(sub_slices),
                       bt=bt_mat, cells=cells.numel(), out=out.numel(),
                       vectors=(scale is not None) + (bias is not None), activation=activation,
                       epilogue=out_mode != "scratch"))
    return out


winograd_conv1d_fused_engine.launches = 0
winograd_conv1d_fused_engine.scratch_launches = 0


@functools.lru_cache(maxsize=256)
def _engine1d_plan(B: int, ty: int, M: int, device_index: int, want: int = -1, want_splits: int = -1):
    """(BT, BM, the most positions and sub-filters a pass, instantiation: 0
    the CUDA cores, 1 or 2 the tensor cores) of the 1D kernel's block
    configuration for B sequences of ty tiles and M channels on this card:
    the tensor cores where M allows them and their blocks fill every SM at
    least once, else the CUDA cores, whose smaller tiles do; or ``want``.
    The library raises the kernel's shared-memory limit here."""
    import ctypes

    from ._build import load_library

    _unsplit("winograd_conv1d_fused_engine", want_splits)
    tile = (ctypes.c_int * 5)()
    with torch.cuda.device(device_index):
        err = load_library().engine1d_plan(B, ty, M, want, tile)
    if err != 0:
        raise _plan_error("winograd_conv1d_fused_engine", err, want, want_splits)
    return tuple(tile)


def _scatter_1d(dxw: torch.Tensor, bt_mat, *, B: int, ty: int, gy: int, m: int, n: int, phases: int):
    """dL/dcells from dL/dxw (B*ty, phases*n, N): dz = B dxw per tile and
    phase, then the overlap sum, cell row g taking tile g - dy's cell offset
    dy (O(n) adds; the reference's host einsum)."""
    q = -(-n // m)
    N = dxw.shape[2]
    b_mat = _bt_1d(bt_mat, m, n, dxw.device).T
    dz = torch.einsum("au,btsuc->btsac", b_mat, dxw.reshape(B, ty, phases, n, N).float())
    dz = torch.nn.functional.pad(dz, (0, 0, 0, q * m - n)).reshape(B, ty, phases, q, m, N)
    acc = dz.new_zeros((B, ty + q - 1, phases, m, N))
    for dy in range(q):
        acc[:, dy : dy + ty] += dz[:, :, :, dy]
    out = acc.reshape(B, ty + q - 1, phases * m, N)
    if out.shape[1] < gy:  # cell rows past the tiles' reach get zero
        out = torch.nn.functional.pad(out, (0, 0, 0, 0, 0, gy - out.shape[1]))
    return out[:, :gy].contiguous()


def _conv1d_bwd_x(bwd_x, g, ww_packed, inv_packed, bt_mat, *, pos_idx, sub_slices, m, n, ty, gy, phases, **conf):
    B, _, s2m, M = g.shape
    dxw = bwd_x(g.reshape(B * ty, s2m, M), ww_packed, inv_packed, pos_idx=pos_idx, sub_slices=sub_slices,
                m2=m, n2=phases * n, **conf)
    return _scatter_1d(dxw, bt_mat, B=B, ty=ty, gy=gy, m=m, n=n, phases=phases).to(g.dtype)


def _conv1d_bwd_w(bwd_w, cells, g, inv_packed, bt_mat, *, pos_idx, sub_slices, m, n, ty, phases, **conf):
    B, _, s2m, M = g.shape
    bt = _bt_1d(bt_mat, m, n, cells.device)
    xw = xw_from_cells_1d(cells, bt, m=m, n=n, ty=ty, phases=phases).to(cells.dtype).contiguous()
    return bwd_w(xw, g.reshape(B * ty, s2m, M), inv_packed, pos_idx=pos_idx, sub_slices=sub_slices, m2=m, **conf)


def winograd_conv1d_fused_bwd_x(
    g: torch.Tensor,  # (B, ty, S2*m, M) scratch-layout cotangent
    ww_packed: torch.Tensor,  # (C, N, M)
    inv_packed: torch.Tensor,  # (C, m) fp32
    bt_mat,
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m: int,
    n: int,
    ty: int,
    gy: int,
    phases: int = 1,
    conf: str | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """dL/dcells (B, gy, phases*m, N) of the 1D engine's products: the
    rank-1 ``domain_engine_bwd_x`` (the packed contraction; ``conf`` /
    ``splits`` are its) then the B-scatter and overlap sum in PyTorch, as
    the reference composes it."""
    return _conv1d_bwd_x(domain_engine_bwd_x, g, ww_packed, inv_packed, bt_mat, pos_idx=pos_idx,
                         sub_slices=sub_slices, m=m, n=n, ty=ty, gy=gy, phases=phases, conf=conf, splits=splits)


def winograd_conv1d_fused_bwd_x_plain(g, ww_packed, inv_packed, bt_mat, *, pos_idx, sub_slices, m, n, ty, gy,
                                      phases=1):
    """Plain version of ``winograd_conv1d_fused_bwd_x``, on any device: the
    same composition around ``domain_engine_bwd_x_plain``."""
    return _conv1d_bwd_x(domain_engine_bwd_x_plain, g, ww_packed, inv_packed, bt_mat, pos_idx=pos_idx,
                         sub_slices=sub_slices, m=m, n=n, ty=ty, gy=gy, phases=phases)


def winograd_conv1d_fused_bwd_w(
    cells: torch.Tensor,  # (B, Gy, phases*m, N) the forward's cells
    g: torch.Tensor,  # (B, ty, S2*m, M)
    inv_packed: torch.Tensor,  # (C, m) fp32
    bt_mat,
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m: int,
    n: int,
    ty: int,
    phases: int = 1,
    conf: str | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """dL/dww (C, N, M) of the 1D engine's products: the rank-1 transformed
    tiles recomputed in PyTorch, the tile axis reduced by the rank-1
    ``domain_engine_bwd_w`` (``conf`` / ``splits`` are its), as the
    reference composes it."""
    return _conv1d_bwd_w(domain_engine_bwd_w, cells, g, inv_packed, bt_mat, pos_idx=pos_idx,
                         sub_slices=sub_slices, m=m, n=n, ty=ty, phases=phases, conf=conf, splits=splits)


def winograd_conv1d_fused_bwd_w_plain(cells, g, inv_packed, bt_mat, *, pos_idx, sub_slices, m, n, ty, phases=1):
    """Plain version of ``winograd_conv1d_fused_bwd_w``, on any device: the
    same composition around ``domain_engine_bwd_w_plain``."""
    return _conv1d_bwd_w(domain_engine_bwd_w_plain, cells, g, inv_packed, bt_mat, pos_idx=pos_idx,
                         sub_slices=sub_slices, m=m, n=n, ty=ty, phases=phases)
