"""Configuration autotuner for the Winograd engines' CUDA kernels (the
reference's ``kernels/autotune.py``), measured on the card.

The paper fixes its tiling by an analytic roofline DSE; the reference
measures instead, and so does the port: it enumerates the engines' design
space and times each point of it end to end.  On Hopper a point is not a
block size: each kernel's tiles are compiled into its instantiations, and
the point names the instantiation and the split each launch runs
(``engine.INSTANTIATIONS``, ``engine.SPLIT_LIMITS``).

``EngineConfig``'s fields against the reference's:
  * ``fuse_pre``, ``prepack``, ``epilogue``, ``emit_cells``: the same axes
    (the fused pre-PE engine or the unfused one, the G-transform and pack
    hoisted out of the timed region, the fused finalize's activation, the
    cell-layout output that chains into the next layer);
  * ``block_t``, ``block_ty``, ``block_n``, ``block_m`` -> ``conf`` and
    ``splits``: the forward kernel's instantiation (a name from
    ``INSTANTIATIONS["domain_engine"]`` for the unfused engine,
    ``["fused_engine"]`` with ``fuse_pre`` or at the deconv corner's
    epilogue, ``["conv_fused_engine"]`` for a conv layer,
    ``["winograd_conv1d_fused_engine"]`` for a 1D layer) and its split (the
    CUDA-core forwards' N split, the conv forward's pass split).  No TPU
    tile (block_*, the 128-lane padding, VMEM budgets) carries over;
  * ``bwd_block_t``, ``bwd_block_ty``, ``bwd_block_n``, ``bwd_block_m`` ->
    ``bwd_x_conf``, ``bwd_w_conf`` and ``bwd_w_splits``: the backward
    kernels' instantiations and bwd_w's T split;
  * ``None`` in any of these keeps that plan's own choice, as the
    reference's ``None`` mirrors the forward block.
The reference's ``interpret`` becomes the autotuners' ``device``: ``"cuda"``
times the kernels, ``"cpu"`` their plain versions (which checks the
machinery only); the timed functions run where their inputs are.
``mesh=`` (a ``launch.mesh.Mesh``; every rank of it runs the sweep
together) times each candidate under the mesh's layout: this rank's rows of
a batch split over the batch axes, the weight leaf stored as this rank's
block (FSDP over N, TP over M where they divide, as ``gan_param_specs``
places the packed leaves) and gathered on entry, the weight gradient
all-reduced over the batch axes, AdamW on the block.  With
``grad_compression="int8"`` (mode "step" only) the weights replicate and the
gradient's all-reduce is ``parallel.compression.compressed_psum`` with an
error-feedback residual among the arguments: the collective pattern of the
compressed whole-model step.

Entry points:
  candidate_configs(...)  -> the default sweep grid (optional bwd axes)
  autotune_deconv(...)    -> timed sweep for one (dims, input shape) cell,
                             sorted fastest first; ``mode`` selects what is
                             timed: "fwd" (inference), "grad" (the loss and
                             its gradients in the weights and the input: both
                             backward kernels), or "step" (a full AdamW
                             update, lr 1e-3)
  autotune_conv(...), autotune_conv1d(...), best_config(...)
The inputs are drawn from ``np.random.default_rng(seed)`` in the
reference's order, so both packages time the same function on the same
numbers.  ``models.gan.install_tuned_blocks`` wires the winners into the
generator's per-layer applies.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.tdc import DeconvDims
from ..optim import adamw_init, adamw_update
from . import engine, ops

__all__ = [
    "EngineConfig", "candidate_configs", "small_candidates",
    "epilogue_candidates", "conv_candidates", "conv1d_candidates",
    "autotune_deconv", "autotune_conv", "autotune_conv1d", "best_config",
    "make_timed_fn", "make_timed_conv_fn", "make_timed_conv1d_fn", "time_one",
]

_MODES = ("fwd", "grad", "step")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """One point of the engines' design space on Hopper.

    ``conf`` / ``splits`` configure the forward kernel's launch and
    ``bwd_x_conf`` / ``bwd_w_conf`` / ``bwd_w_splits`` the backward ones'
    (names from ``engine.INSTANTIATIONS``; None keeps each plan's choice);
    ``prepack`` times the prepacked-weights path (G-transform + pack out of
    the timed region).  ``epilogue`` (an activation name) times the
    epilogue-fused finalize and ``emit_cells`` the cell-layout output mode
    that chains into the next layer."""

    fuse_pre: bool
    conf: Optional[str] = None
    splits: Optional[int] = None
    bwd_x_conf: Optional[str] = None
    bwd_w_conf: Optional[str] = None
    bwd_w_splits: Optional[int] = None
    prepack: bool = False
    epilogue: Optional[str] = None  # None | "none" | "relu" | "leaky_relu" | "tanh"
    emit_cells: bool = False

    def kwargs(self) -> dict:
        return dict(
            fuse_pre=self.fuse_pre,
            conf=self.conf,
            splits=self.splits,
            bwd_x_conf=self.bwd_x_conf,
            bwd_w_conf=self.bwd_w_conf,
            bwd_w_splits=self.bwd_w_splits,
            epilogue=self.epilogue,
            emit_cells=self.emit_cells,
        )


def _launches(kw: dict) -> dict:
    """The launch keys of ``EngineConfig.kwargs()``: what the conv and 1D
    ops take besides their own axes."""
    return {k: kw[k] for k in ("conf", "splits", "bwd_x_conf", "bwd_w_conf", "bwd_w_splits")}


def _conf_axis(kernel: str, conf: Optional[Sequence[Optional[str]]]) -> Sequence[Optional[str]]:
    return (None, *engine.INSTANTIATIONS[kernel]) if conf is None else conf


def _with_splits(confs, splits, split_conf: Optional[str] = None) -> list[tuple]:
    """(conf, splits) pairs: each conf with the plan's split (None), and
    with every count in ``splits`` the instantiation ``split_conf`` (None:
    every named one): a split needs the conf it splits."""
    return [(c, k) for c in confs for k in splits
            if k is None or (c == split_conf if split_conf is not None else c is not None)]


def candidate_configs(
    *,
    conf: Optional[Sequence[Optional[str]]] = None,
    splits: Sequence[Optional[int]] = (None, 1, 2, 4),
    bwd_x_conf: Sequence[Optional[str]] = (None,),
    bwd_w_conf: Sequence[Optional[str]] = (None,),
    bwd_w_splits: Sequence[Optional[int]] = (None,),
    include_fused: bool = True,
    include_unfused: bool = True,
    prepack: bool = False,
    epilogue: Sequence[Optional[str]] = (None,),
    emit_cells: Sequence[bool] = (False,),
) -> list[EngineConfig]:
    """The default sweep grid over the forward kernel's instantiations and
    splits and the pre-PE fusion choice.

    ``conf`` None enumerates the plan's choice and every instantiation of
    the variant's forward kernel (``domain_engine`` unfused,
    ``fused_engine`` fused); ``splits`` pair with ``"cuda_cores"``, the
    instantiation the forward splits.  The backward axes default to a single
    None (the plans' choice) so forward-only sweeps stay the same size;
    pass names (``bwd_x_conf=("cuda_cores", "mma_64x32")``) to sweep the
    backward kernels too (``bwd_w_splits`` pair with a named
    ``bwd_w_conf``).  ``epilogue`` / ``emit_cells`` sweep the fused
    finalize's epilogue and cell-chaining output modes (fused-pre configs
    only: the unfused engine has no in-kernel depth-to-space)."""
    out: list[EngineConfig] = []
    bwd = [(bx, bw, bws) for bx in bwd_x_conf for bw, bws in _with_splits(bwd_w_conf, bwd_w_splits)]
    if include_unfused:
        out.extend(
            EngineConfig(False, conf=c, splits=k, bwd_x_conf=bx, bwd_w_conf=bw, bwd_w_splits=bws, prepack=prepack)
            for c, k in _with_splits(_conf_axis("domain_engine", conf), splits, "cuda_cores")
            for bx, bw, bws in bwd
        )
    if include_fused:
        out.extend(
            EngineConfig(True, conf=c, splits=k, bwd_x_conf=bx, bwd_w_conf=bw, bwd_w_splits=bws, prepack=prepack,
                         epilogue=epi, emit_cells=ec)
            for c, k in _with_splits(_conf_axis("fused_engine", conf), splits, "cuda_cores")
            for bx, bw, bws in bwd
            for epi in epilogue
            for ec in emit_cells
        )
    return out


def epilogue_candidates(conf: Sequence[Optional[str]] = (None, "cuda_cores")) -> list[EngineConfig]:
    """Compact fused-pre sweep over the epilogue / chain axes: scratch-out
    vs epilogue-fused NHWC vs cell-layout chaining, per forward
    instantiation."""
    out: list[EngineConfig] = []
    for c in conf:
        out.append(EngineConfig(True, conf=c))
        out.append(EngineConfig(True, conf=c, epilogue="leaky_relu"))
        out.append(EngineConfig(True, conf=c, epilogue="leaky_relu", emit_cells=True))
    return out


def conv_candidates(
    conf: Optional[Sequence[Optional[str]]] = None,
    *,
    epilogue: Sequence[Optional[str]] = (None, "leaky_relu"),
    emit_cells: Sequence[bool] = (False, True),
    prepack: bool = True,
) -> list[EngineConfig]:
    """Sweep grid for the Winograd conv engine (always fused: the conv
    engine consumes the phase-major cell layout) over its forward
    instantiations (``conf`` None: the plan's and every one of
    ``INSTANTIATIONS["conv_fused_engine"]``), including the epilogue /
    cell-chaining output axes: the conv mirror of
    ``epilogue_candidates``."""
    out: list[EngineConfig] = []
    for c in _conf_axis("conv_fused_engine", conf):
        for epi in epilogue:
            for ec in emit_cells:
                if ec and epi is None:
                    continue  # chained emit always rides an epilogue config
                out.append(EngineConfig(True, conf=c, prepack=prepack, epilogue=epi, emit_cells=ec))
    return out


def small_candidates() -> list[EngineConfig]:
    """The compact fused-vs-unfused grid: each variant on its plan's choice
    and on the CUDA cores, one axis of variation each."""
    return [
        EngineConfig(False),
        EngineConfig(False, conf="cuda_cores"),
        EngineConfig(True),
        EngineConfig(True, conf="cuda_cores"),
    ]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(args):
    for a in args:
        for t in (a if isinstance(a, tuple) else (a,)):
            if isinstance(t, torch.Tensor):
                return t.device
    return torch.device("cpu")


def time_one(fn, args, repeats: int) -> float:
    """Seconds of the fastest of ``repeats`` calls of ``fn(*args)``, each
    bracketed by a device synchronize, after one warm-up call (the build,
    the plan and the first launch)."""
    device = _device_of(args)
    fn(*args)
    _sync(device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _loss_and_grad(fwd, get_leaf, set_leaf):
    """(loss, gradient of the trained leaf, gradient of the input) of
    sum(y^2)."""
    def loss_and_grad(x, p):
        leaf = get_leaf(p).detach().requires_grad_(True)
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = fwd(xg, set_leaf(p, leaf)).float().square().sum()
            g, dx = torch.autograd.grad(loss, (leaf, xg))
        return loss.detach(), g, dx

    return loss_and_grad


def _timed(fwd, make_params, get_leaf, set_leaf, mode: str):
    """The callable the sweep times, per mode, and its argument builder:
    "fwd" the forward; "grad" (loss, gradient of the trained leaf, gradient
    of the input) of sum(y^2); "step" an AdamW update of that leaf (lr
    1e-3), returning (params, opt state).  "grad" and "step" pull the
    input's gradient as every layer but a network's first does in its
    backward: so the bwd_x kernel runs and ``bwd_x_conf`` is timed ("step"
    drops it).  (The reference differentiates in the weights alone, and XLA
    drops the unused input cotangent with its bwd_x engine: its "grad" gives
    (loss, gradient of the leaf).)"""

    loss_and_grad = _loss_and_grad(fwd, get_leaf, set_leaf)
    if mode == "fwd":
        def fn(x, p):
            with torch.no_grad():
                return fwd(x, p)
    elif mode == "grad":
        fn = loss_and_grad
    elif mode == "step":
        def fn(x, p, opt):
            _, g, _ = loss_and_grad(x, p)
            leaf2, opt2, _ = adamw_update(get_leaf(p), g, opt, lr=1e-3)
            return set_leaf(p, leaf2), opt2
    else:
        raise ValueError(mode)

    def make_args(x, w):
        p = make_params(w)
        if mode == "step":
            return (x, p, adamw_init(get_leaf(p)))
        return (x, p)

    return fn, make_args


def _mesh_layout(mesh, input_shape, c_out: int, prepack: bool, grad_compression: Optional[str]):
    """(x spec, weight-leaf spec, fallback log) of a layer on ``mesh``, by
    ``gan_param_specs``' rules; compressed: the weights replicate."""
    from ..parallel import sharding as SH

    axes = SH.MeshAxes.for_mesh(mesh)
    b = SH.SpecBuilder(mesh, axes)
    B, _, _, N = input_shape
    xspec = SH.P(b.dim("x.B", B, axes.batch), None, None, None)
    if grad_compression is not None:
        return xspec, SH.P(*([None] * (3 if prepack else 4))), []
    n_ax, m_ax = b.dim("w.N", N, axes.fsdp), b.dim("w.M", c_out, SH._tp_or_none(mesh, axes))
    return xspec, SH.P(None, n_ax, m_ax) if prepack else SH.P(None, None, n_ax, m_ax), b.fallbacks


def _mesh_timed(fwd, make_params, get_leaf, set_leaf, mode: str, mesh, input_shape, c_out: int, prepack: bool,
                grad_compression: Optional[str]):
    """``_timed``'s callables for every rank of ``mesh`` (see the module
    docstring): the forward, gradient or step on this rank's rows, the
    weight leaf gathered from its blocks on entry."""
    import torch.distributed as dist

    from ..parallel import sharding as SH
    from ..parallel.compression import compressed_psum

    xspec, wspec, _ = _mesh_layout(mesh, input_shape, c_out, prepack, grad_compression)
    axes = SH.MeshAxes.for_mesh(mesh).batch
    group = mesh.group(axes) if axes else None
    rows = mesh.extent(axes)
    if grad_compression is not None and input_shape[0] % rows:
        raise ValueError(f"batch {input_shape[0]} not divisible by {rows} shards")
    loss_and_grad = _loss_and_grad(fwd, get_leaf, set_leaf)
    full = lambda p: set_leaf(p, SH.gather(get_leaf(p), wspec, mesh))  # noqa: E731

    def weight_grad(x, p):
        """The gradient of the global batch's loss, this rank's block of it."""
        loss, g, dx = loss_and_grad(x, full(p))
        if xspec[0] is not None:
            dist.all_reduce(g, group=group)
        return loss, SH.block_of(g, wspec, mesh), dx

    if mode == "fwd":
        def fn(x, p):
            with torch.no_grad():
                return fwd(x, full(p))
    elif mode == "grad":
        fn = weight_grad
    elif grad_compression is not None:
        def fn(x, p, opt, res):
            _, g, _ = loss_and_grad(x, p)
            red, r2 = compressed_psum(g, res[0], group, axis_size=rows)
            leaf2, opt2, _ = adamw_update(get_leaf(p), red, opt, lr=1e-3)
            return set_leaf(p, leaf2), opt2, r2[None]
    else:
        def fn(x, p, opt):
            _, g, _ = weight_grad(x, p)
            leaf2, opt2, _ = adamw_update(get_leaf(p), g, opt, lr=1e-3)
            return set_leaf(p, leaf2), opt2

    def make_args(x, w):
        p = make_params(w)
        p = set_leaf(p, SH.block_of(get_leaf(p), wspec, mesh))
        args = (SH.block_of(x, xspec, mesh), p)
        if mode == "step":
            args += (adamw_init(get_leaf(p)),)
        if grad_compression is not None:
            args += (torch.zeros((1, *get_leaf(p).shape), dtype=torch.float32, device=x.device),)
        return args

    return fn, make_args


def _identity_params():
    return (lambda w: w), (lambda p: p), (lambda p, leaf: leaf)


def _check_mesh_args(mode: str, mesh, grad_compression: Optional[str]) -> None:
    if grad_compression is not None:
        if grad_compression != "int8":
            raise ValueError(f"unknown grad_compression: {grad_compression!r}")
        if mode != "step" or mesh is None:
            raise ValueError("grad_compression requires mode='step' and a mesh")


def make_timed_fn(cfg: Optional[EngineConfig], dims: DeconvDims, mode: str, mesh=None,
                  grad_compression: Optional[str] = None, input_shape=None, c_out: Optional[int] = None):
    """Build the callable the sweep times for one deconv layer, per mode x
    variant; returns (fn, make_args), make_args(x, w) giving fn's arguments.

    ``cfg=None`` times the plain Winograd DeConv (``core.winograd_deconv2d``:
    no kernel, no packing), as the reference times its pure-JAX path;
    ``cfg.prepack`` hoists the G-transform + pack out of the timed region
    and trains the packed leaf.  The kernels run for CUDA tensors (the
    inputs ``make_args`` is given), their plain versions for CPU ones (the
    reference's ``interpret``).  With ``mesh`` (which needs ``input_shape``
    and ``c_out`` for the divisibility rules) every rank of the mesh calls
    the callable on its rows and its weight block; ``grad_compression=
    "int8"`` (mode "step" with a mesh) times the compressed
    data-parallel step (see the module docstring)."""
    _check_mesh_args(mode, mesh, grad_compression)
    if mesh is not None and (input_shape is None or c_out is None):
        raise ValueError("mesh timing needs input_shape and c_out")
    if cfg is None:
        from ..core.winograd_deconv import winograd_deconv2d

        fwd = lambda x, p: winograd_deconv2d(x, p, dims)  # noqa: E731
        make_params, get_leaf, set_leaf = _identity_params()
    elif cfg.prepack:
        kw = cfg.kwargs()
        fwd = lambda x, p: ops.winograd_deconv2d_packed(x, p, dims, **kw)  # noqa: E731
        make_params = lambda w: ops.prepack(w, dims)  # noqa: E731
        get_leaf = lambda p: p.ww  # noqa: E731
        set_leaf = lambda p, leaf: ops.PackedDeconv(leaf, p.inv)  # noqa: E731
    else:
        kw = cfg.kwargs()
        fwd = lambda x, p: ops.winograd_deconv2d_fused(x, p, dims, **kw)  # noqa: E731
        make_params, get_leaf, set_leaf = _identity_params()
    if mesh is not None:
        return _mesh_timed(fwd, make_params, get_leaf, set_leaf, mode, mesh, input_shape, c_out,
                           cfg is not None and cfg.prepack, grad_compression)
    return _timed(fwd, make_params, get_leaf, set_leaf, mode)


def make_timed_conv_fn(cfg: Optional[EngineConfig], cdims, mode: str):
    """Conv counterpart of ``make_timed_fn``: the timed callable for one
    discriminator conv layer.  ``cfg=None`` times ``F.conv2d`` (the
    reference's ``lax.conv``: the pre-engine baseline, with the layer's
    (padding, pad_hi) pads); otherwise the Winograd conv engine, with
    ``cfg.prepack`` hoisting the G-transform + pack out of the timed region
    and ``cfg.epilogue`` / ``cfg.emit_cells`` selecting the fused finalize's
    output mode."""
    if cfg is None:
        def fwd(x, p):
            pads = (cdims.padding, cdims.pad_hi) * 2
            y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pads), p.permute(3, 2, 0, 1), stride=cdims.stride)
            return y.permute(0, 2, 3, 1)

        make_params, get_leaf, set_leaf = _identity_params()
    else:
        kw = dict(_launches(cfg.kwargs()), epilogue=cfg.epilogue, emit_cells=cfg.emit_cells)
        if cfg.prepack:
            fwd = lambda x, p: ops.winograd_conv2d_packed(x, p, cdims, **kw)  # noqa: E731
            make_params = lambda w: ops.prepack_conv(w, cdims)  # noqa: E731
            get_leaf = lambda p: p.ww  # noqa: E731
            set_leaf = lambda p, leaf: ops.PackedConv(leaf, p.inv)  # noqa: E731
        else:
            fwd = lambda x, p: ops.winograd_conv2d(x, p, cdims, **kw)  # noqa: E731
            make_params, get_leaf, set_leaf = _identity_params()
    return _timed(fwd, make_params, get_leaf, set_leaf, mode)


def conv1d_candidates(
    conf: Optional[Sequence[Optional[str]]] = None,
    *,
    prepack: bool = True,
) -> list[EngineConfig]:
    """Sweep grid for the 1D engine (audio deconv / SSM prefill conv): the
    plan's choice and every instantiation of
    ``INSTANTIATIONS["winograd_conv1d_fused_engine"]`` (``conf`` None), or
    the names given; the 1D kernel runs unsplit."""
    return [EngineConfig(True, conf=c, prepack=prepack) for c in _conf_axis("winograd_conv1d_fused_engine", conf)]


def make_timed_conv1d_fn(cfg: Optional[EngineConfig], geom, mode: str):
    """1D counterpart of ``make_timed_conv_fn``.  ``geom`` is either an int
    kernel size (stride-1 causal conv: the SSM prefill shape) or a
    ``DeconvDims`` (the audio decoder's upsampling deconv).  ``cfg=None``
    times the framework's convolution for the same geometry
    (``models.gan.lax_deconv1d``, or ``F.conv1d`` after a causal pad)."""
    is_deconv = isinstance(geom, DeconvDims)
    if cfg is None:
        if is_deconv:
            from ..models.gan import lax_deconv1d

            fwd = lambda x, p: lax_deconv1d(x, p, geom)  # noqa: E731
        else:
            def fwd(x, p):
                y = F.conv1d(F.pad(x.permute(0, 2, 1), (geom - 1, 0)), p.permute(2, 1, 0))
                return y.permute(0, 2, 1)

        make_params, get_leaf, set_leaf = _identity_params()
    else:
        kw = _launches(cfg.kwargs())
        if is_deconv:
            if cfg.prepack:
                fwd = lambda x, p: ops.winograd_deconv1d_packed(x, p, geom, **kw)  # noqa: E731
                make_params = lambda w: ops.prepack_deconv1d(w, geom)  # noqa: E731
            else:
                fwd = lambda x, p: ops.winograd_deconv1d(x, p, geom, **kw)  # noqa: E731
                make_params = lambda w: w  # noqa: E731
        else:
            if cfg.prepack:
                fwd = lambda x, p: ops.winograd_conv1d_packed(x, p, geom, **kw)  # noqa: E731
                make_params = lambda w: ops.prepack_conv1d(w, geom)  # noqa: E731
            else:
                fwd = lambda x, p: ops.winograd_conv1d(x, p, **kw)  # noqa: E731
                make_params = lambda w: w  # noqa: E731
        if cfg.prepack:
            get_leaf = lambda p: p.ww  # noqa: E731
            set_leaf = lambda p, leaf: ops.PackedConv1d(leaf, p.inv)  # noqa: E731
        else:
            _, get_leaf, set_leaf = _identity_params()
    return _timed(fwd, make_params, get_leaf, set_leaf, mode)


def _check_mode(mode: str, device) -> None:
    """A bad mode or device is the caller's error, not a configuration's
    infeasibility: raise before any row."""
    if mode not in _MODES:
        raise ValueError(mode)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("autotune on device 'cuda' needs a CUDA device (device='cpu' times the plain versions)")


def _sweep(make, candidates, args_of, repeats: int, extra=None) -> list[dict]:
    """Rows {config, ms, ok, error} (and ``extra(cfg)``'s keys) for every
    candidate, fastest first; a configuration that fails (a plan's refusal,
    an instantiation the shape does not take) stays in the rows with ok
    False and its error."""
    rows: list[dict] = []
    for cfg in candidates:
        row = {"config": cfg, **(extra(cfg) if extra else {})}
        try:
            fn, make_args = make(cfg)
            dt = time_one(fn, args_of(make_args), repeats)
            rows.append({**row, "ms": dt * 1e3, "ok": True, "error": ""})
        except Exception as e:  # an infeasible configuration, out of memory, ...
            rows.append({**row, "ms": float("inf"), "ok": False, "error": f"{type(e).__name__}: {e}"[:200]})
    rows.sort(key=lambda r: r["ms"])
    return rows


def _inputs(rng, shapes, dtype, device):
    return [torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=device) for s in shapes]


def autotune_conv1d(
    geom,  # int kernel (stride-1 causal conv) | DeconvDims (1D deconv)
    input_shape: tuple[int, int, int],  # (B, L, N)
    c_out: int,
    *,
    dtype=torch.float32,
    candidates: Iterable[EngineConfig] | None = None,
    device="cuda",
    repeats: int = 3,
    seed: int = 0,
    mode: str = "fwd",
) -> list[dict]:
    """Time every candidate 1D engine config for one conv1d / deconv1d
    layer (``mode`` as in ``autotune_deconv``).  Returns rows sorted fastest
    first; infeasible configs kept with ok=False."""
    _check_mode(mode, device)
    if candidates is None:
        candidates = conv1d_candidates()
    B, L, N = input_shape
    K = geom.kernel if isinstance(geom, DeconvDims) else geom
    x, w = _inputs(np.random.default_rng(seed), [(B, L, N), (K, N, c_out)], dtype, device)
    return _sweep(lambda cfg: make_timed_conv1d_fn(cfg, geom, mode), candidates,
                  lambda make_args: make_args(x, w), repeats)


def autotune_conv(
    cdims,
    input_shape: tuple[int, int, int, int],  # (B, H, W, N)
    c_out: int,
    *,
    dtype=torch.float32,
    candidates: Iterable[EngineConfig] | None = None,
    device="cuda",
    repeats: int = 3,
    seed: int = 0,
    mode: str = "fwd",
) -> list[dict]:
    """Time every candidate conv engine config for one discriminator layer
    (``mode`` as in ``autotune_deconv``).  Returns rows sorted fastest
    first; infeasible configs kept with ok=False."""
    _check_mode(mode, device)
    if candidates is None:
        candidates = conv_candidates()
    B, H, W, N = input_shape
    x, w = _inputs(np.random.default_rng(seed), [(B, H, W, N), (cdims.kernel, cdims.kernel, N, c_out)], dtype,
                   device)
    return _sweep(lambda cfg: make_timed_conv_fn(cfg, cdims, mode), candidates,
                  lambda make_args: make_args(x, w), repeats)


def autotune_deconv(
    dims: DeconvDims,
    input_shape: tuple[int, int, int, int],  # (B, H, W, N)
    c_out: int,
    *,
    dtype=torch.float32,
    candidates: Iterable[EngineConfig] | None = None,
    device="cuda",
    repeats: int = 3,
    seed: int = 0,
    mode: str = "fwd",
    mesh=None,
    grad_compression: Optional[str] = None,
) -> list[dict]:
    """Time every candidate engine config for one deconv layer.

    ``mode='fwd'`` times inference; ``'grad'`` the loss and its gradient
    (the backward kernels); ``'step'`` a full AdamW update.  Returns a list
    of rows {config, ms, ok, error} sorted fastest first; configs that fail
    to plan or run are kept (ok=False) so sweeps surface infeasible corners
    instead of hiding them.  ``device="cpu"`` times the plain versions (the
    machinery, not the card).

    ``mesh`` times each candidate under the mesh's layout (every rank of it
    calls ``autotune_deconv`` with the same arguments; see the module
    docstring), and each row carries ``sharding_fallbacks``, the dims that
    replicated (a sweep that claims the sharded layout says when it timed a
    replicated one); ``grad_compression="int8"`` (mode "step" with a mesh)
    times the compressed data-parallel step."""
    _check_mode(mode, device)
    _check_mesh_args(mode, mesh, grad_compression)
    if candidates is None:
        candidates = candidate_configs()
    B, H, W, N = input_shape
    x, w = _inputs(np.random.default_rng(seed), [(B, H, W, N), (dims.kernel, dims.kernel, N, c_out)], dtype,
                   device)
    extra = None
    if mesh is not None and grad_compression is None:
        extra = lambda cfg: {"sharding_fallbacks": _mesh_layout(  # noqa: E731
            mesh, input_shape, c_out, cfg is not None and cfg.prepack, None)[2]}
    return _sweep(lambda cfg: make_timed_fn(cfg, dims, mode, mesh=mesh, grad_compression=grad_compression,
                                            input_shape=input_shape, c_out=c_out),
                  candidates, lambda make_args: make_args(x, w), repeats, extra)


def best_config(
    dims: DeconvDims,
    input_shape: tuple[int, int, int, int],
    c_out: int,
    **kw,
) -> EngineConfig:
    """The fastest config of ``autotune_deconv``'s rows that ran; raises
    RuntimeError when none ran."""
    rows = autotune_deconv(dims, input_shape, c_out, **kw)
    for r in rows:
        if r["ok"]:
            return r["config"]
    raise RuntimeError(f"no engine config ran for {dims}: {rows[0]['error']}")
