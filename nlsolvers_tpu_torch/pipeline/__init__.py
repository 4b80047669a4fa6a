"""Datagen pipeline of the port (counterpart of nlsolvers_tpu/pipeline/).

The host modules (grids, spaces, fields, downsample, samplers/, io_hdf5) are
copies of the JAX package's numpy code, kept numpy-only with the same RNG
calls in the same order, so that one seed draws equal arrays in both
packages; they are copies because importing the JAX package's imports JAX.
engine.py runs a batch of trajectories on the port's problems and kernels,
datagen.py and __main__.py are the sweep and its CLI
(`python -m nlsolvers_tpu_torch.pipeline nlse|realwave ...`).
"""

from nlsolvers_tpu_torch.pipeline import downsample, fields, grids, spaces
from nlsolvers_tpu_torch.pipeline.grids import Grid2D, Grid3D
