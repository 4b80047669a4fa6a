"""Percent of their least time that the hand-written kernels reach in the
traced call (portbench/roofline: bytes at 3.35 TB/s or float32 operations
at 67 TFLOP/s, from the shapes), summed over every family traced."""

from portbench.roofline import kernel_share


def read(rec):
    return kernel_share(rec)
