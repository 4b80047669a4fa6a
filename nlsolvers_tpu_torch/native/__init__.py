"""Native runtime components of the port (C++ via ctypes).

A copy of nlsolvers_tpu/native/: the async .npy snapshot writer
(snapshot_writer.cpp, the same source), replacing the reference's libnpy
util (common/include/util.hpp:37-92) and synchronous snapshot streaming
(nlse_dev.hpp:323-334) with a thread-pool writer that overlaps disk IO with
device compute during datagen.

The shared library is compiled on first use with g++ into
nlsolvers_tpu_torch/_build/ (git-ignored, beside the CUDA kernels' builds),
keyed by a hash of the source, so the repo carries no binary. If no compiler
is available the import still succeeds; AsyncNpyWriter raises at
construction and callers fall back to numpy.save.
"""

import ctypes
import hashlib
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["AsyncNpyWriter", "write_npy_sync", "load_library",
           "NativeUnavailable"]

_SRC = Path(__file__).with_name("snapshot_writer.cpp")
_BUILD = Path(__file__).resolve().parents[1] / "_build"

_DESCR = {
    np.dtype(np.float32): "<f4", np.dtype(np.float64): "<f8",
    np.dtype(np.complex64): "<c8", np.dtype(np.complex128): "<c16",
    np.dtype(np.int32): "<i4", np.dtype(np.int64): "<i8",
    np.dtype(np.uint8): "|u1", np.dtype(bool): "|b1",
}


class NativeUnavailable(RuntimeError):
    pass


_lib = None
_lib_error = None


def _compile():
    _BUILD.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD / f"libsnapshot_{tag}.so"
    if so.exists():
        return so
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
           str(_SRC), "-o", str(so)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return so


def load_library():
    """Load (compiling if needed) the native library; raises
    NativeUnavailable if the toolchain is missing or the build fails."""
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if _lib_error is not None:
        raise NativeUnavailable(_lib_error)
    try:
        lib = ctypes.CDLL(str(_compile()))
    except (OSError, subprocess.CalledProcessError) as e:
        _lib_error = f"native snapshot writer unavailable: {e}"
        raise NativeUnavailable(_lib_error) from e

    lib.sw_create.restype = ctypes.c_void_p
    lib.sw_create.argtypes = [ctypes.c_int]
    lib.sw_destroy.argtypes = [ctypes.c_void_p]
    lib.sw_submit.restype = ctypes.c_int
    lib.sw_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_char_p, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int64)]
    lib.sw_flush.argtypes = [ctypes.c_void_p]
    lib.sw_pending.restype = ctypes.c_int64
    lib.sw_pending.argtypes = [ctypes.c_void_p]
    lib.sw_errors.restype = ctypes.c_int64
    lib.sw_errors.argtypes = [ctypes.c_void_p]
    lib.sw_write_sync.restype = ctypes.c_int
    lib.sw_write_sync.argtypes = lib.sw_submit.argtypes[1:]
    _lib = lib
    return lib


def _descr_shape(arr):
    arr = np.ascontiguousarray(arr)
    descr = _DESCR.get(arr.dtype)
    if descr is None:
        raise TypeError(f"unsupported dtype for native npy: {arr.dtype}")
    shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
    return arr, descr.encode(), shape


class AsyncNpyWriter:
    """Thread-pool .npy writer. submit() copies the array and returns
    immediately; flush() blocks until all files are on disk."""

    def __init__(self, n_threads=2):
        self._lib = load_library()
        self._h = self._lib.sw_create(int(n_threads))

    def submit(self, path, arr):
        arr, descr, shape = _descr_shape(arr)
        rc = self._lib.sw_submit(
            self._h, str(path).encode(), arr.ctypes.data_as(ctypes.c_void_p),
            arr.nbytes, descr, arr.ndim, shape)
        if rc != 0:
            raise RuntimeError(f"sw_submit failed for {path}")

    def flush(self):
        self._lib.sw_flush(self._h)

    @property
    def pending(self):
        return self._lib.sw_pending(self._h)

    @property
    def errors(self):
        return self._lib.sw_errors(self._h)

    def close(self):
        if self._h:
            self._lib.sw_flush(self._h)
            self._lib.sw_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_npy_sync(path, arr):
    """Synchronous native .npy write (save_to_npy parity); falls back to
    numpy.save when the native library is unavailable."""
    try:
        lib = load_library()
    except NativeUnavailable:
        np.save(path, np.ascontiguousarray(arr))
        return
    arr, descr, shape = _descr_shape(arr)
    rc = lib.sw_write_sync(str(path).encode(),
                           arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes,
                           descr, arr.ndim, shape)
    if rc != 0:
        raise RuntimeError(f"native npy write failed for {path}")
