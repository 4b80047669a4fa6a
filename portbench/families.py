"""What differs between the port's PDE families, in one table: the state a
cell's traffic hands in, the snapshot fields its trajectory function
returns, and the planes of float32 a grid point holds.

A configuration names its family (`family`, the DatagenConfig field), and
the harness takes everything family-specific from here:

  traffic/generate.make_inputs  builds the family's state, one tensor per
                                name of `state`, from a lane's recipe
  bench.run_cell                calls traj(*state, m, c, S, freq) and reads
                                back the `fields`, then bad_at
  check.judge                   holds snapshot 0 of a field against the
                                state tensor at the same position
  roofline.Shape                counts a Krylov column as `planes` float32
                                planes

The trajectory functions are pipeline/engine.make_nlse_trajectory_fn
(traj(u0_packed, m, c, S, freq) -> (snaps, bad_at)) and
make_realwave_trajectory_fn (traj(u0, v0, m, c, S, freq) -> (u, v,
bad_at)), both with the guard on.
"""

from dataclasses import dataclass

import torch

__all__ = ["Family", "FAMILIES", "family", "held"]


@dataclass(frozen=True)
class Family:
    """`state`: the names of the tensors the traffic hands in, in the order
    of the trajectory function's first arguments; `fields`: the names of
    the snapshot stacks it returns first, in order (field i at snapshot 0
    is state i as the engine holds it), bad_at after them; `planes`: the
    float32 planes of a grid point (2 for complex, 1 for real); `lane`:
    what a lane's initial-condition recipe returns, as the state's rows."""
    state: tuple
    fields: tuple
    planes: int
    lane: object


def _nlse_lane(ic, mix):
    """A complex u, scaled to a peak of 1 where the mix asks for it (the
    sweep's normalize_ic), as its (re, im) planes."""
    if mix.get("normalize_ic", True):
        peak = ic.abs().max()
        ic = torch.where(peak > 0, ic / peak, ic)
    return (torch.stack([ic.real, ic.imag]),)


def _realwave_lane(ic, mix):
    """(u0, v0) real, as the recipe returns them."""
    del mix
    return tuple(ic)


FAMILIES = {
    "nlse": Family(state=("u0",), fields=("u",), planes=2, lane=_nlse_lane),
    "realwave": Family(state=("u0", "v0"), fields=("u", "v"), planes=1,
                       lane=_realwave_lane),
}


def family(cfg):
    """The Family of a configuration's DatagenConfig fields."""
    name = cfg["family"]
    if name not in FAMILIES:
        raise ValueError(f"unknown family {name!r}; known: {sorted(FAMILIES)}")
    return FAMILIES[name]


def held(fam, out, host):
    """A trajectory function's outputs read back by `host` (as the sweep's
    Datagen._fetch_* reads them): dict(fields={name: stack}, bad_at=...)."""
    n = len(fam.fields)
    fields = {name: host(x) for name, x in zip(fam.fields, out[:n])}
    return dict(fields=fields, bad_at=host(out[n]))
