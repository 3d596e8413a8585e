"""Build the CUDA sources of this package with nvcc and load them with ctypes.

The shared library goes to ``build/repro_torch/`` at the root of the
checkout, named by a hash of the sources, their headers and the flags, and
is built on first use: one ``nvcc`` per source, all started together, then
one link.  A missing ``nvcc`` or a failed build raises; nothing falls back.
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
SOURCES = ("fused_engine.cu", "fused_engine_bwd.cu", "conv_engine.cu", "domain_engine.cu", "engine1d.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_p = ctypes.c_void_p
_i = ctypes.c_int
# name -> argtypes of each C entry point
_SIGNATURES = {
    "fused_engine_plan": [_i] * 9 + [ctypes.POINTER(_i)] + [ctypes.POINTER(ctypes.c_longlong)] * 2
    + [ctypes.POINTER(_i)],
    "fused_engine_epi_f32": [_p] * 9 + [_i] * 19 + [_p] * 3,
    "fused_engine_bwd_x_plan": [_i] * 7 + [ctypes.POINTER(_i)] * 5,
    "fused_engine_bwd_x_f32": [_p] * 6 + [_i] * 13 + [_p],
    "fused_engine_bwd_w_plan": [_i] * 10 + [ctypes.POINTER(_i)] + [ctypes.POINTER(ctypes.c_longlong)] * 2
    + [ctypes.POINTER(_i)],
    "fused_engine_bwd_w_f32": [_p] * 6 + [_i] * 11 + [_p] * 3,
    "conv_engine_fwd_conf": [_i] * 4 + [ctypes.POINTER(_i)],
    "conv_engine_fwd_plan": [_i] * 13 + [ctypes.POINTER(_i)] + [ctypes.POINTER(ctypes.c_longlong)] * 2,
    "conv_engine_fwd_f32": [_p] * 9 + [_i] * 18 + [_p] * 3,
    "conv_engine_bwd_x_plan": [_i] * 8 + [ctypes.POINTER(_i)] * 4,
    "conv_engine_bwd_x_f32": [_p] * 6 + [_i] * 12 + [_p],
    "conv_engine_bwd_w_plan": [_i] * 10 + [ctypes.POINTER(_i)] + [ctypes.POINTER(ctypes.c_longlong)] * 2
    + [ctypes.POINTER(_i)],
    "conv_engine_bwd_w_f32": [_p] * 6 + [_i] * 11 + [_p] * 3,
    "domain_engine_fwd_plan": [_i] * 8 + [ctypes.POINTER(_i)] + [ctypes.POINTER(ctypes.c_longlong)] * 2
    + [ctypes.POINTER(_i)],
    "domain_engine_fwd_f32": [_p] * 6 + [_i] * 7 + [_p] * 3,
    "domain_engine_bwd_x_plan": [_i] * 4 + [ctypes.POINTER(_i)],
    "domain_engine_bwd_x_f32": [_p] * 6 + [_i] * 8 + [_p],
    "domain_engine_bwd_w_plan": [_i] * 9 + [ctypes.POINTER(_i)] + [ctypes.POINTER(ctypes.c_longlong)] * 2
    + [ctypes.POINTER(_i)],
    "domain_engine_bwd_w_f32": [_p] * 6 + [_i] * 9 + [_p] * 3,
    "engine1d_plan": [_i] * 4 + [ctypes.POINTER(_i)],
    "engine1d_f32": [_p] * 10 + [_i] * 16 + [_p],
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
    """The library's path, named by a hash of every source and header under
    ``CSRC`` (``*.cu``, ``*.cuh``) and the flags: an edit to any of them
    builds anew."""
    h = hashlib.sha256()
    for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfused_engine_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmpdir = Path(tempfile.mkdtemp(dir=out.parent))
    t0 = time.perf_counter()
    try:
        objs = [tmpdir / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n{log}")
        tmp = tmpdir / out.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    last_build_log.update(seconds=time.perf_counter() - t0, log="".join(logs))


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
