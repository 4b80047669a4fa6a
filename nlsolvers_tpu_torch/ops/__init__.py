"""Operators, boundaries, the Krylov core and the CUDA kernels."""
