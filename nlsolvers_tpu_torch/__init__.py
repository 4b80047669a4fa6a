"""nlsolvers_tpu_torch: the PyTorch/CUDA port of nlsolvers_tpu.

Keeps the JAX package's module names (config, ops.operators, ops.boundaries,
ops.krylov, models.*) so each counterpart is easy to find. The Lanczos hot
loop of the 2D and 3D NLSE and of the real-wave Gautschi step, the SS2
kicks and the 3D ghost copy run through hand-written CUDA kernels for
Hopper (ops/cuda/, csrc/), built with nvcc at first use.
Importing the package imports torch only, never jax.
"""

from nlsolvers_tpu_torch import config

__all__ = ["config"]
