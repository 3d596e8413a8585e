"""Fault-tolerant checkpointing: atomic, keep-k, verified, in the
reference's on-disk format (``train/checkpoint.py`` of the JAX package).

Layout: ``<dir>/step_<N>/`` with one ``.npy`` per flattened tree leaf plus
a JSON manifest holding each leaf's key path, shape, logical dtype and
sha256.  A checkpoint written by either package restores in the other:

  * key paths are the strings ``jax.tree_util.keystr`` prints: a dict key
    as ``['k']`` (dict keys walked in sorted order, as JAX flattens them),
    a NamedTuple field as ``.field``, a list or tuple index as ``[i]``;
  * a Python int leaf (``OptState.step``) is saved as a 0-d int32, the
    array the reference's optimizer holds, and restored as an int;
  * dtypes numpy lacks (bfloat16, the float8s) are saved as their raw
    bytes viewed as uint8 under their logical dtype name, as the reference
    does with ml_dtypes, and read back through torch's dtype of that name;
  * each leaf's sha256 is taken over the bytes of the array as saved.

Writes go to a tmp dir; every leaf file, the loop-state sidecar, the
manifest and the tmp dir are fsync'd, then ``os.replace`` renames it into
place and the parent dir is fsync'd, then old steps are pruned to ``keep``.
A crash mid-save never leaves a torn checkpoint that passes the listing.

Integrity: restore verifies every leaf's sha256 (a manifest without one
loads unverified), so a truncated or bit-flipped leaf, an unreadable
manifest or a damaged sidecar raises ``CheckpointCorruptError``;
``restore_latest_valid`` walks the kept steps newest first and returns the
first that verifies.  A shape mismatch on a valid sha is the caller's
error (``ValueError``), never skipped as corruption.

Placement: leaves are restored onto ``device`` (the card by default), or
with ``shardings=`` (a tree of ``parallel.sharding.Placement``s matching
``like``) onto a mesh: each rank keeps its block of every leaf, on the
mesh's device.  The checkpoint always holds full leaves, so one saved on
one mesh restores on another mesh or on one device (elastic restore).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["MANIFEST", "LOOP_STATE", "CheckpointCorruptError", "save_checkpoint", "latest_step",
           "available_steps", "load_loop_state", "verify_checkpoint", "restore_checkpoint",
           "restore_latest_valid"]

MANIFEST = "manifest.json"
LOOP_STATE = "loop_state.json"


def _fsync_dir(path: str) -> None:
    """Durably record a directory's entries (the rename itself).  Some
    filesystems refuse a directory fsync: best effort there, the per-file
    fsyncs still hold."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class CheckpointCorruptError(RuntimeError):
    """The checkpoint on disk fails integrity verification: a leaf file is
    missing, unreadable or truncated, its bytes do not match the manifest's
    sha256, or the manifest or the loop-state sidecar is damaged."""


_NATIVE_NUMPY = {
    np.dtype(t)
    for t in ("float64", "float32", "float16", "int64", "int32", "int16", "int8",
              "uint64", "uint32", "uint16", "uint8", "bool", "complex64", "complex128")
}
_NATIVE_NAMES = {str(d) for d in _NATIVE_NUMPY}


def _flatten(tree, path: str = "") -> list[tuple[str, Any]]:
    """(key path, leaf) of every leaf, in JAX's flattening order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple (OptState)
        return [item for f in tree._fields for item in _flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in _flatten(v, f"{path}[{i}]")]
    if tree is None:  # an empty subtree, as in JAX
        return []
    return [(path, tree)]


def _rebuild(like, fn, path: str = ""):
    """``like``'s structure with each leaf replaced by ``fn(key path, leaf)``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, fn, f"{path}[{k!r}]") for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), fn, f"{path}.{f}") for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, fn, f"{path}[{i}]") for i, v in enumerate(like))
    if like is None:
        return None
    return fn(path, like)


def _host_array(leaf) -> tuple[np.ndarray, str, list[int]]:
    """(the array as saved, its logical dtype, its logical shape) of one
    leaf: a tensor copied to the host, a dtype numpy lacks as its raw bytes
    viewed as uint8; a Python int (``OptState.step``) as the 0-d int32 the
    reference's optimizer holds."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name in _NATIVE_NAMES:
            return t.numpy(), name, list(t.shape)
        return t.reshape(t.shape or (1,)).view(torch.uint8).numpy(), name, list(t.shape)
    arr = np.asarray(leaf, np.int32) if isinstance(leaf, int) else np.asarray(leaf)
    if arr.dtype not in _NATIVE_NUMPY:
        raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__} ({arr.dtype})")
    return arr, str(arr.dtype), list(arr.shape)


def _leaf_sha(arr: np.ndarray) -> str:
    """sha256 over the raw bytes of the array as saved: the bytes ``np.load``
    hands back, so the restore side needs no dtype handling (hashed through
    the array's buffer: the digest of ``arr.tobytes()`` without the copy)."""
    return hashlib.sha256(np.ascontiguousarray(arr).data).hexdigest()


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:012d}")


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3, loop_state: Optional[dict] = None) -> str:
    """Atomically persist ``tree`` (nested dicts, NamedTuples, lists of
    tensors and Python ints) at ``step``; prune to the newest ``keep``.

    ``loop_state`` (a small JSON-serializable dict) rides along as a
    sha-verified sidecar: the trainer's metrics history and loop counters,
    so resume after preemption is bit-exact.  Every file is fsync'd before
    the atomic rename."""
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (keypath, leaf) in enumerate(_flatten(tree)):
        arr, logical_dtype, shape = _host_array(leaf)
        fpath = os.path.join(tmp, f"leaf_{i}.npy")
        with open(fpath, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({"key": keypath, "file": f"leaf_{i}.npy", "shape": shape,
                                   "dtype": logical_dtype, "sha256": _leaf_sha(arr)})
    if loop_state is not None:
        blob = json.dumps(loop_state).encode()
        with open(os.path.join(tmp, LOOP_STATE), "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        manifest["loop_state"] = {"file": LOOP_STATE, "sha256": hashlib.sha256(blob).hexdigest()}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(directory)
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d))


def available_steps(directory: str) -> list[int]:
    """The kept checkpoint steps on disk, ascending (no validity check)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    steps = available_steps(directory)
    return max(steps) if steps else None


def _load_manifest(path: str) -> dict:
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable manifest: {e}") from e


def _load_leaf(path: str, rec: dict) -> np.ndarray:
    """One leaf off disk, verified against its manifest record (sha256 when
    present: older manifests without it load unverified)."""
    fpath = os.path.join(path, rec["file"])
    try:
        arr = np.load(fpath)
    except Exception as e:  # a truncated or garbage .npy: numpy raises a zoo of errors
        raise CheckpointCorruptError(f"{fpath}: unreadable leaf ({type(e).__name__}: {e})") from e
    want_sha = rec.get("sha256")
    if want_sha is not None:
        got = _leaf_sha(arr)
        if got != want_sha:
            raise CheckpointCorruptError(f"{fpath}: sha256 mismatch (manifest {want_sha[:12]}…, disk {got[:12]}…)")
    return arr


def load_loop_state(directory: str, step: int) -> Optional[dict]:
    """The ``loop_state`` sidecar saved with ``step``'s checkpoint, or None
    for a checkpoint written without one.  A sidecar the manifest promises
    but that is missing, unreadable, fails its sha256 or is not JSON raises
    ``CheckpointCorruptError``: it is part of the checkpoint."""
    path = _step_dir(directory, step)
    rec = _load_manifest(path).get("loop_state")
    if rec is None:
        return None
    fpath = os.path.join(path, rec["file"])
    try:
        with open(fpath, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise CheckpointCorruptError(f"{fpath}: unreadable loop state: {e}") from e
    got = hashlib.sha256(blob).hexdigest()
    if got != rec["sha256"]:
        raise CheckpointCorruptError(f"{fpath}: sha256 mismatch (manifest {rec['sha256'][:12]}…, disk {got[:12]}…)")
    try:
        return json.loads(blob.decode())
    except (ValueError, UnicodeDecodeError) as e:  # sha ok, but not JSON
        raise CheckpointCorruptError(f"{fpath}: undecodable loop state: {e}") from e


def verify_checkpoint(directory: str, step: int) -> None:
    """Raise ``CheckpointCorruptError`` unless every leaf of ``step``'s
    checkpoint (and its loop-state sidecar, when present) is on disk and
    matches its manifest sha256."""
    path = _step_dir(directory, step)
    for rec in _load_manifest(path)["leaves"]:
        _load_leaf(path, rec)
    load_loop_state(directory, step)


def restore_checkpoint(directory: str, step: int, like, *, device="cuda", shardings=None):
    """Restore into the structure of ``like`` (a tree of tensors and Python
    ints, as ``save_checkpoint`` takes; meta tensors do as templates), each
    tensor leaf with ``like``'s dtype on ``device``, each int leaf as an int.
    ``shardings``: a matching tree of ``Placement``s; each tensor leaf is
    then this rank's block under its spec, on its mesh's device (``like``
    keeps the full shapes).
    Leaves are looked up by key path and verified against the manifest's
    sha256 on the way in; corruption raises ``CheckpointCorruptError``, a
    missing leaf ``KeyError``, a shape other than ``like``'s ``ValueError``."""
    path = _step_dir(directory, step)
    by_key = {rec["key"]: rec for rec in _load_manifest(path)["leaves"]}
    placed = dict(_flatten(shardings)) if shardings is not None else {}

    def restore(keypath, leaf):
        rec = by_key.get(keypath)
        if rec is None:
            raise KeyError(f"checkpoint missing leaf {keypath}")
        arr = _load_leaf(path, rec)
        t = torch.from_numpy(arr)
        if rec["dtype"] not in _NATIVE_NAMES:  # raw bytes of a dtype numpy lacks
            t = t.view(getattr(torch, rec["dtype"])).reshape(rec["shape"])
        want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
        if tuple(t.shape) != want:
            # a valid sha with a wrong shape is the caller's error (the wrong
            # ``like``), not disk damage: the fallback walk must not skip it
            raise ValueError(f"{keypath}: ckpt shape {tuple(t.shape)} != wanted {want}")
        if not isinstance(leaf, torch.Tensor):
            return type(leaf)(t.item())
        if shardings is None:
            return t.to(device=device, dtype=leaf.dtype)
        where = placed.get(keypath)
        if where is None:
            raise KeyError(f"shardings= has no placement for leaf {keypath}")
        from ..parallel.sharding import block_of

        return block_of(t, where.spec, where.mesh).to(device=where.mesh.device, dtype=leaf.dtype)

    # leaves in the reference's (flattening) order, so a walk past a damaged
    # checkpoint reads what the reference's would before the damage shows
    restored = {keypath: restore(keypath, leaf) for keypath, leaf in _flatten(like)}
    return _rebuild(like, lambda keypath, _: restored[keypath])


def restore_latest_valid(directory: str, like, *, device="cuda", shardings=None,
                         on_skip=None) -> tuple[Optional[int], Any]:
    """Restore the newest checkpoint that passes integrity verification,
    walking older steps when the latest is corrupt (the keep-k window is
    the redundancy budget).  Returns ``(step, tree)``, or ``(None, None)``
    when no valid checkpoint exists.  ``on_skip(step, error)`` is called
    for every corrupt step skipped.  ``shardings`` as ``restore_checkpoint``."""
    for step in reversed(available_steps(directory)):
        try:
            tree = restore_checkpoint(directory, step, like, device=device, shardings=shardings)
            load_loop_state(directory, step)  # the sidecar must verify too
            return step, tree
        except CheckpointCorruptError as e:
            if on_skip is not None:
                on_skip(step, e)
    return None, None
