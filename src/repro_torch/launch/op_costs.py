"""Per-rank op and collective counts of a step, from an eager trace (the
reference's ``launch/hlo_costs.py`` and ``launch/hlo_analysis.py`` in one
module).

The reference reads the compiled, partitioned HLO of a step.  The port has
no compiled program: one rank runs its step eagerly, and ``OpRecorder`` (a
``TorchDispatchMode``) writes down every aten op and every ``c10d``
collective that rank runs, and every hand-written kernel launch, which
dispatch cannot see, read from ``kernels.engine.launch_log``.  An op
record is a plain dict (``op``, its tensors' dtypes, shapes and device
types, the arguments of the ops that have a FLOP formula, a collective's
group size and global ranks, a kernel's counted work), so a saved record can be analysed
again without tracing (``launch/reanalyze.py``).

The reference's functions and their counterparts:

  hlo_costs.CostModel / analyze_text       analyze_records (totals of a record)
  hlo_analysis.collective_stats            collective_stats
  HLO ``dot`` / ``convolution`` FLOPs      torch.utils.flop_counter's formulas
                                           (mm, addmm, bmm, baddbmm, the
                                           convolutions and their backward)
  _ELEMENTWISE_FLOP_OPS                    _ELEMENTWISE (aten names), one flop
                                           an output element
  ``reduce`` / ``reduce-window``           _REDUCTIONS, one flop an input
                                           element (softmax counted as one)
  _FREE_OPS                                views (``OpOverload.is_view``) and
                                           _FREE: no bytes
  f32 dot classification                   the matmul's first operand's dtype
                                           (float32 / float64); bf16 matmul
                                           FLOPs are kept beside it
  while-loop trip counts                   none: an eager trace records every
                                           op each time it runs, so nothing is
                                           multiplied (the reason the reference
                                           has hlo_costs at all, XLA counting a
                                           while body once, does not arise)

Bytes (``hbm_bytes_per_device``) are each op's operand plus result bytes,
as the reference counts every top-level instruction; a copy between host
and device memory (the gloo staging of ``models/moe.py`` and
``parallel/``) is counted apart as ``host_copy_bytes_per_device``.

Collectives map onto the reference's names with its ring factors, g the
size of the op's process group (a group of one moves nothing):

  all-gather          allgather_, _allgather_base_       full size * (g-1)/g
  reduce-scatter      reduce_scatter_, _reduce_scatter_base_  operand * (g-1)/g
  all-reduce          allreduce_                          2 * size * (g-1)/g
  all-to-all          alltoall_, alltoall_base_           size * (g-1)/g
  collective-permute  send                                size

Ops with no counterpart in the reference: ``broadcast_`` counts its size
(each rank but the root receives it once), ``recv_`` its count and bytes
but no wire bytes (the sender counts them), ``barrier`` its count only.

A hand-written kernel's FLOPs, bytes and products come from
``kernels/costs.py``: its ``ops`` count as FLOPs and its ``products`` as
f32 matmul FLOPs (fp32 operands).  This deviates from the reference on
purpose: its HLO shows a Pallas kernel as a custom-call, and counts its
bytes only.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpRecorder", "analyze_records", "collective_stats", "tensors_of"]

_ELEMENTWISE = {  # by the reference's opcode: add multiply subtract divide maximum minimum power exponential
    # log rsqrt sqrt tanh logistic negate abs sign floor ceil round-nearest-afz expm1 log1p atan2 compare select
    # clamp and or xor not cosine sine erf, and the activations XLA lowers to one of them
    "add", "add_", "mul", "mul_", "sub", "sub_", "rsub", "div", "div_", "maximum", "minimum", "clamp_min",
    "clamp_max", "pow", "pow_", "exp", "exp_", "log", "rsqrt", "sqrt", "tanh", "tanh_", "sigmoid", "neg", "abs",
    "sign", "floor", "ceil", "round", "expm1", "log1p", "atan2", "eq", "ne", "lt", "le", "gt", "ge", "where",
    "clamp", "clamp_", "logical_and", "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "cos", "sin", "erf", "reciprocal", "square", "relu", "relu_", "leaky_relu",
    "leaky_relu_", "silu", "gelu", "softplus", "addcmul", "addcmul_", "addcdiv", "addcdiv_", "lerp", "lerp_",
    "tanh_backward", "sigmoid_backward", "threshold_backward", "leaky_relu_backward", "silu_backward",
    "gelu_backward", "softplus_backward", "isfinite", "isnan", "masked_fill", "masked_fill_",
}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "var_mean", "std", "norm", "linalg_vector_norm",
    "logsumexp", "_softmax", "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data", "any",
    "all", "argmax", "argmin", "cumsum", "_foreach_norm",
}
_FREE = {  # metadata and allocation: no bytes, no flops
    "detach", "alias", "lift_fresh", "_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "resize_", "set_", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "_to_copy_meta",
}
_MATMULS = {"mm", "addmm", "bmm", "baddbmm"}
_COLLECTIVES = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "allreduce_": "all-reduce", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "recv", "broadcast_": "broadcast", "barrier": "barrier",
}
_DTYPE_BYTES: dict[str, int] = {}


def _itemsize(dt: str) -> int:
    if dt not in _DTYPE_BYTES:
        _DTYPE_BYTES[dt] = torch.empty((), dtype=getattr(torch, dt), device="meta").element_size()
    return _DTYPE_BYTES[dt]


def tensors_of(x, out: Optional[list] = None) -> list:
    """The tensors in ``x`` (nested lists, tuples and dicts), in order."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            tensors_of(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            tensors_of(v, out)
    return out


def _desc(t: torch.Tensor) -> list:
    return [str(t.dtype).removeprefix("torch."), list(t.shape), t.device.type]


def _json_args(x):
    """An op's arguments as JSON: a tensor as ``{"t": shape}``."""
    if isinstance(x, torch.Tensor):
        return {"t": list(x.shape)}
    if isinstance(x, (list, tuple)):
        return [_json_args(v) for v in x]
    if isinstance(x, (bool, int, float, str)) or x is None:
        return x
    if isinstance(x, torch.dtype):
        return str(x)
    return None


def _shape_args(x):
    """``_json_args`` back to what a FLOP formula takes (shapes for tensors)."""
    if isinstance(x, dict) and "t" in x:
        return torch.Size(x["t"])
    if isinstance(x, list):
        return [_shape_args(v) for v in x]
    return x


def _group(args):
    import torch.distributed as dist

    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return dist.ProcessGroup.unbox(a)
    return None


def _group_size(args) -> Optional[int]:
    pg = _group(args)
    return None if pg is None else pg.size()


def _group_ranks(args) -> Optional[list]:
    """The global ranks of a collective's group (which mesh axes it runs
    over), where torch knows them."""
    import torch.distributed as dist

    pg = _group(args)
    try:
        return None if pg is None else dist.get_process_group_ranks(pg)
    except (RuntimeError, ValueError, KeyError):
        return None


def _bytes_of(x) -> int:
    return sum(t.numel() * t.element_size() for t in tensors_of(x))


def _collective_size(func, args, kwargs) -> int:
    """The bytes the reference's ring factor takes: an all-gather's full
    (gathered) output, a reduce-scatter's full operand, the tensors of every
    other collective (an all-to-all's input)."""
    named = dict(zip((a.name for a in func._schema.arguments), args), **kwargs)
    base = _COLLECTIVES.get(func._opname, func._opname)
    if base == "all-gather":
        return _bytes_of(named.get("output_tensors", named.get("output_tensor")))
    if base in ("reduce-scatter", "all-to-all"):
        return _bytes_of(named.get("input_tensors", named.get("input_tensor", named.get("input"))))
    if base == "barrier":
        return 0
    return _bytes_of(named.get("tensors"))


def _flop_formula(op: str):
    from torch.utils.flop_counter import flop_registry

    ns, name = op.split(".")[:2]
    return flop_registry.get(getattr(getattr(torch.ops, ns), name)) if ns == "aten" else None


class OpRecorder(TorchDispatchMode):
    """Record every op one rank runs while the mode is on (``records``).

    Kernel launches are read from ``kernels.engine.launch_log``, which the
    recorder turns on for its span (and restores after), in launch order
    among the aten ops; their work is counted when the mode exits, so a
    CUDA ``inv`` is read to the host after the step, not inside it.

    ``track_memory=True`` also follows every storage an op creates, from
    its first output to its last reference (a weak finalizer): ``live_bytes``
    now, ``peak_live_bytes`` the most at once, both counted from
    ``base_bytes`` (the argument storages the caller already holds)."""

    def __init__(self, *, track_memory: bool = False, base_bytes: int = 0):
        super().__init__()
        self.records: list[dict] = []
        self.track_memory = track_memory
        self.live_bytes = self.peak_live_bytes = base_bytes
        self._live: dict[int, int] = {}
        self._launches: list = []
        self._seen = 0
        self._saved_log = None

    # -------------------------------------------------------------- mode
    def __enter__(self):
        from ..kernels import engine

        self._saved_log = engine.launch_log
        engine.launch_log = self._launches
        return super().__enter__()

    def __exit__(self, *exc):
        from ..kernels import engine

        out = super().__exit__(*exc)
        self._drain()
        engine.launch_log = self._saved_log
        self._count_kernels()
        return out

    def _drain(self) -> None:
        while self._seen < len(self._launches):
            self.records.append({"op": "kernel", "launch": self._launches[self._seen]})
            self._seen += 1

    def _count_kernels(self) -> None:
        from ..kernels import costs

        for rec in self.records:
            launch = rec.pop("launch", None)
            if launch is None:
                continue
            w = costs.of_launch(launch)
            scalars = lambda d: {k: v for k, v in d.items() if isinstance(v, (int, str))}  # noqa: E731
            rec.update(kernel=launch.kernel, conf=launch.conf, splits=launch.splits, shape=scalars(launch.shape),
                       work=scalars(launch.work), products=w.products, ops=w.ops, bytes=w.bytes)

    def hold(self, tensors) -> None:
        """Count the storages of ``tensors`` (the caller's arguments) as
        live from the start."""
        self._track(tensors)

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":  # metadata queries (prim.device and the like)
            return func(*args, **kwargs)
        self._drain()
        out = func(*args, **kwargs)
        op = str(func)
        ins, outs = tensors_of((args, kwargs)), tensors_of(out)
        rec = {"op": op, "in": [_desc(t) for t in ins], "out": [_desc(t) for t in outs]}
        if func.namespace == "c10d":
            rec["group"], rec["size"] = _group_size(args), _collective_size(func, args, kwargs)
            rec["ranks"] = _group_ranks(args)
        elif func.is_view:
            rec["view"] = True
        elif _flop_formula(op) is not None:
            rec["args"], rec["kwargs"] = _json_args(args), {k: _json_args(v) for k, v in kwargs.items()}
            rec["out_val"] = _json_args(out)
        self.records.append(rec)
        if self.track_memory:
            self._track(outs)
        return out


# ---------------------------------------------------------------- totals
def _nbytes(descs) -> int:
    total = 0
    for dt, shape, _ in descs:
        n = 1
        for d in shape:
            n *= d
        total += n * _itemsize(dt)
    return total


def _nelems(descs) -> int:
    total = 0
    for _, shape, _ in descs:
        n = 1
        for d in shape:
            n *= d
        total += n
    return total


def _wire(rec: dict) -> tuple[str, int, int]:
    """(the reference's op name, bytes, wire bytes) of a collective record."""
    name = rec["op"].split(".")[1]
    base, size, g = _COLLECTIVES.get(name, name), rec["size"], rec.get("group") or 1
    if base in ("all-gather", "reduce-scatter", "all-to-all"):
        return base, size, size * (g - 1) // g
    if base == "all-reduce":
        return base, size, 2 * size * (g - 1) // g
    return base, size, 0 if base in ("recv", "barrier") or g == 1 else size


def collective_stats(records: list[dict]) -> dict:
    """The counterpart of ``hlo_analysis.collective_stats``:
    ``{"wire_bytes_per_device", "by_op": {op: {"count", "bytes", "wire_bytes"}}}``."""
    by_op: dict[str, dict] = defaultdict(lambda: {"count": 0, "bytes": 0, "wire_bytes": 0})
    for rec in records:
        if not rec["op"].startswith("c10d."):
            continue
        base, size, wire = _wire(rec)
        d = by_op[base]
        d["count"] += 1
        d["bytes"] += size
        d["wire_bytes"] += wire
    return {"wire_bytes_per_device": sum(d["wire_bytes"] for d in by_op.values()), "by_op": dict(by_op)}


def _host_copy(rec: dict) -> bool:
    devs = {d[2] for d in rec["in"] + rec["out"]}
    return len(devs) > 1 and "cpu" in devs and rec["op"].split(".")[1] in ("_to_copy", "copy_", "copy")


def analyze_records(records: list[dict]) -> dict:
    """The counterpart of ``hlo_costs.analyze_text``: per-rank totals of an
    op record (each collective's group size is in its record, so the
    reference's ``n_devices`` has no counterpart)."""
    flops = f32 = bf16 = byts = host = 0
    for rec in records:
        op = rec["op"]
        if op == "kernel":
            flops += rec["ops"]
            f32 += rec["products"]
            byts += rec["bytes"]
            continue
        if op.startswith("c10d."):
            byts += _nbytes(rec["in"]) + _nbytes(rec["out"])
            continue
        name = op.split(".")[1]
        if rec.get("view") or name in _FREE:
            continue
        if _host_copy(rec):
            host += _nbytes(rec["out"])
            continue
        byts += _nbytes(rec["in"]) + _nbytes(rec["out"])
        if "args" in rec:
            f = _flop_formula(op)(*_shape_args(rec["args"]), out_val=_shape_args(rec["out_val"]),
                                  **{k: _shape_args(v) for k, v in rec["kwargs"].items()})
            flops += f
            if name in _MATMULS:
                dt = next((d[0] for d in rec["in"] if len(d[1]) >= 2), None)
                if dt in ("float32", "float64"):
                    f32 += f
                elif dt == "bfloat16":
                    bf16 += f
        elif name in _ELEMENTWISE:
            flops += _nelems(rec["out"])
        elif name in _REDUCTIONS:
            flops += _nelems(rec["in"][:1]) if name != "_foreach_norm" else _nelems(rec["in"])
    stats = collective_stats(records)
    return {
        "flops_per_device": float(flops),
        "f32_matmul_flops_per_device": float(f32),
        "bf16_matmul_flops_per_device": float(bf16),
        "hbm_bytes_per_device": float(byts),
        "collective_wire_bytes_per_device": float(stats["wire_bytes_per_device"]),
        "collectives_by_op": {k: {"count": v["count"], "wire_bytes": v["wire_bytes"]} for k, v in stats["by_op"].items()},
        "host_copy_bytes_per_device": float(host),
    }

