"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled with nvcc for sm_90a into a shared library with a
plain C interface, at first use (never at import), into
nlsolvers_tpu_torch/_build/, keyed by a hash of the source, the shared
headers (csrc/*.cuh) and the flags, and loaded with ctypes. `build_all`
starts one nvcc per source at once. A build that fails raises; nothing
falls back.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["library", "build_all", "build_seconds", "build_log"]

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


def _target(name):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names):
    """Build every csrc/<name>.cu not built yet, one nvcc each, all started
    together, and load them. Raises if any build fails."""
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        if name in _loaded:
            continue
        src, so = _target(name)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            jobs.append((name, src, so, tmp, cmd, proc))
        else:
            jobs.append((name, src, so, None, None, None))
    failed = []
    for name, src, so, tmp, cmd, proc in jobs:
        log = so.with_suffix(".log")
        if proc is not None:
            out, err = proc.communicate()
            # ptxas -v reports registers, shared memory and spills per kernel
            log.write_text(" ".join(cmd) + "\n" + out + err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src.name}:\n{err}")
                continue
            os.replace(tmp, so)
        _loaded[name] = ctypes.CDLL(str(so))
        _seconds[name] = time.perf_counter() - t0
        _logs[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name):
    """ctypes handle of csrc/<name>.cu, built on first call."""
    if name not in _loaded:
        build_all([name])
    return _loaded[name]


def build_seconds(name):
    """Seconds from the start of the build_all call that built (or found)
    library(name) until it was loaded."""
    return _seconds[name]


def build_log(name):
    """nvcc's command line and output (with ptxas -v's register and spill
    report per kernel) for the library(name) that is loaded."""
    return _logs[name]
