"""Percent of its least time that the pipe_2d kernels reach in the traced
call (portbench/roofline/pipe_2d.py)."""

from portbench.roofline import kernel_share


def read(rec):
    return kernel_share(rec, only=("pipe_2d",))
