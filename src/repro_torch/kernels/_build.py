"""Build the CUDA sources of this package with nvcc and load them with ctypes.

The shared library goes to ``build/repro_torch/`` at the root of the
checkout, named by a hash of the sources and flags, and is built on first
use.  A missing ``nvcc`` or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "library_path", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fused_engine.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_p = ctypes.c_void_p
_i = ctypes.c_int
# name -> argtypes of each C entry point
_SIGNATURES = {
    "fused_engine_plan": [_i] * 7 + [ctypes.POINTER(_i)] + [ctypes.POINTER(ctypes.c_longlong)] * 2,
    "fused_engine_epi_f32": [_p] * 8 + [_i] * 14 + [_p] * 3,
}

# what the last build printed (ptxas register / spill report), for the smoke log
last_build_log: dict = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, the PATH, or /usr/local/cuda, else raise."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfused_engine_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    last_build_log.update(seconds=time.perf_counter() - t0, log=proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if the hashed library is missing) and load the kernels."""
    out = library_path()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
