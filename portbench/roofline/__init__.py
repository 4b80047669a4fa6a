"""Peaks of the card and the byte and operation counts of the work.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its full power limit of 700 W): 3.35 TB/s of HBM3 and 67 TFLOP/s of
float32 outside the tensor cores. A least time is the larger of the bytes
at the first and the float32 operations at the second.

Counts come from the shapes alone, each input read once and each output
written once, so they do not depend on what the cache held:

  portbench/roofline/<family>.py        per_step(shape) of one kernel family:
                                        (launches, bytes, flops) of its
                                        launches in one batched step, or None
                                        where the family is not on the path
  portbench/roofline/kernel_names/<family>.txt
                                        the CUDA function names (one a line)
                                        that belong to the family
  portbench/roofline/step_<integrator>.py
                                        the whole step's algorithm of an
                                        integrator (step_ss2.py: SS2),
                                        whatever kernels implement it

A kernel family is added by adding its two files. The families' counts are
those of the SS2 path's launches; a reader of another path (the real-wave
Gautschi step's two matrix functions, P = 1) passes kernel_share counts of
its own from files it adds.
"""

import importlib
from dataclasses import dataclass
from pathlib import Path

__all__ = ["HBM_BYTES_PER_S", "F32_FLOPS_PER_S", "Shape", "least_s",
           "families", "family_of", "per_step", "kernel_share"]

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

HERE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Shape:
    """What the counts need of a cell: B lanes of an (nx,)*dim grid,
    Krylov m, the operator's face weights per cell (dim planes for
    div(c grad u), 0 for the Laplacian), and the float32 planes of the
    state (2, re and im, for complex; 1 for real)."""
    B: int
    dim: int
    nx: int
    krylov_m: int
    weight_planes: int
    planes: int = 2

    @property
    def points(self):
        return self.B * self.nx ** self.dim

    @property
    def col(self):
        """Bytes of one Krylov column of the batch (`planes` float32
        planes)."""
        return 4 * self.planes * self.points

    @property
    def wbytes(self):
        return 4 * self.weight_planes * self.points


def least_s(nbytes, flops):
    """Least time in seconds for `nbytes` of device-memory traffic and
    `flops` float32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def families(root=HERE):
    """{kernel function name: family} from kernel_names/*.txt."""
    out = {}
    for path in sorted((Path(root) / "kernel_names").glob("*.txt")):
        for line in path.read_text().splitlines():
            if line.strip():
                out[line.strip()] = path.stem
    return out


def family_of(kernel_name, names):
    """The family of a profiler kernel name ("void (anonymous
    namespace)::pipe_2d_kernel<2, ...>(float const*, ...)"), or None."""
    from portbench.trace import short_name
    return names.get(short_name(kernel_name).split("::")[-1])


def per_step(family, shape):
    """(launches, bytes, flops) of `family` in one batched step of `shape`,
    or None when the family has no launches on that path."""
    mod = importlib.import_module(f"portbench.roofline.{family}")
    return mod.per_step(shape)


def kernel_share(rec, only=None, counts=per_step):
    """Percent of their least time that the hand-written kernels of the
    traced call reach: the sum of each family's least time (counts(family,
    shape), per_step by default, scaled by the launches traced) over the
    sum of their traced device time. Only the families in `only`, when
    given; None when none was traced."""
    if rec.trace is None:
        return None
    names = families()
    seen = {}
    for name, _, s, e in rec.trace.kernels():
        fam = family_of(name, names)
        if fam is not None and (only is None or fam in only):
            n, t = seen.get(fam, (0, 0.0))
            seen[fam] = (n + 1, t + (e - s))
    least = spent = 0.0
    for fam, (n, t) in seen.items():
        got = counts(fam, rec.shape)
        if got is None:
            continue
        launches, nbytes, flops = got
        least += least_s(nbytes, flops) * n / launches
        spent += t
    return 100.0 * least / spent if spent > 0 else None
