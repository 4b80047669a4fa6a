"""Global numerical configuration of the PyTorch/CUDA port.

Counterpart of nlsolvers_tpu/config.py. Production state is float32 /
complex64; the CPU tests run float64 / complex128 against the JAX package.
All public APIs take explicit dtypes and devices; these are the defaults.
"""

import numpy as np
import torch

default_real_dtype = torch.float32
default_complex_dtype = torch.complex64

# Default Krylov subspace dimension (same as the JAX package's).
default_krylov_m = 10

# Hand-written CUDA kernel dispatch for the Lanczos hot loop (ops/cuda/):
#   "auto"  CUDA tensors go through the kernels, CPU tensors through the
#           plain PyTorch versions beside them. A CUDA tensor never reaches
#           a plain version: a kernel that cannot run raises.
#   "off"   plain versions everywhere, and ops/krylov takes its generic
#           path. Only the tests and chip_smoke.py set it, to compare.
kernel_mode = "auto"

_KERNEL_MODES = ("auto", "off")

# Three opt-in single-kernel paths, off by default as in the JAX package.
# Each is parity-tested against the default path; PERF.md records what the
# H100 measured for each beside it.
#
# resident_mode: "auto" runs a complex64 2D SS2 problem on the 5-point
# Laplacian (no-flux or no BC) whose theta = |dt| 8 |scale| <= 3.5 as ONE
# kernel per step (ops/cuda/resident2d.py, K13): a cooperative launch that
# does both kicks, the Lanczos loop, a Taylor series for exp(i dt T) e1 in
# place of the eigendecomposition, the combine and the ghost ring. One
# launch and no host sync per step, against ~300 launches and one eigh
# sync on the streaming path, at the cost of ~1.1 GB of traffic per step
# at 1024^2 (the basis streams from device memory) against ~0.7 GB.
resident_mode = "off"

# fused_iter: each iteration of the normalized two-pass Lanczos loop as one
# cooperative launch (ops/cuda/lanczos2d.iter_step, K5), on the 2D
# operators and the 3D Laplacian, for fields of at most 32 MiB (the w
# intermediate then stays within the H100's 50 MB L2). It replaces the 2D
# pipe and the 3D two-pass loop; the 3D c(x) operator is refused, as the
# JAX package's kernel has no mode for it.
fused_iter = False

# pipeline_3d: the 3D single-pass pipe (ops/cuda/lanczos3d.pipe_3d, K8):
# j+2 column streams per iteration instead of the two-pass loop's 2j+4.
pipeline_3d = False

_RESIDENT_MODES = ("off", "auto")


def use_kernel(x):
    """True when `x` goes through a hand-written kernel under kernel_mode."""
    if kernel_mode not in _KERNEL_MODES:
        raise ValueError(f"kernel_mode must be one of {_KERNEL_MODES}, "
                         f"got {kernel_mode!r}")
    return kernel_mode == "auto" and x.is_cuda


def use_resident():
    """True when resident_mode lets a qualifying SS2 problem take K13."""
    if resident_mode not in _RESIDENT_MODES:
        raise ValueError(f"resident_mode must be one of {_RESIDENT_MODES}, "
                         f"got {resident_mode!r}")
    return resident_mode == "auto"


def real_dtype_of(dtype):
    """Real dtype matching a possibly complex dtype."""
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)


_TORCH_DTYPES = {np.dtype(np.complex64): torch.complex64,
                 np.dtype(np.complex128): torch.complex128,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy type or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype)]
