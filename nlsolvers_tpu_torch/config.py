"""Global numerical configuration of the PyTorch/CUDA port.

Counterpart of nlsolvers_tpu/config.py. Production state is float32 /
complex64; the CPU tests run float64 / complex128 against the JAX package.
All public APIs take explicit dtypes and devices; these are the defaults.
"""

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


def use_kernel(x):
    """True when `x` goes through a hand-written kernel under kernel_mode."""
    if kernel_mode not in _KERNEL_MODES:
        raise ValueError(f"kernel_mode must be one of {_KERNEL_MODES}, "
                         f"got {kernel_mode!r}")
    return kernel_mode == "auto" and x.is_cuda


def real_dtype_of(dtype):
    """Real dtype matching a possibly complex dtype."""
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)
