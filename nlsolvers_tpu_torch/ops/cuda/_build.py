"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled with nvcc for sm_90a into a shared library with a
plain C interface, at first use (never at import), into
nlsolvers_tpu_torch/_build/, keyed by a hash of the source and the flags, and
loaded with ctypes. A build that fails raises; nothing falls back.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["library", "build_seconds", "build_log"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_loaded = {}
_seconds = {}
_logs = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def library(name):
    """ctypes handle of csrc/<name>.cu, built on first call."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{key}.so"
    log = so.with_suffix(".log")
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        # ptxas -v reports registers, shared memory and spills per kernel
        log.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _seconds[name] = time.perf_counter() - t0
    _logs[name] = log
    _loaded[name] = lib
    return lib


def build_seconds(name):
    """Seconds the first library(name) call took (build and load)."""
    return _seconds[name]


def build_log(name):
    """nvcc's command line and output (with ptxas -v's register and spill
    report per kernel) for the library(name) that is loaded."""
    return _logs[name]
