"""The one traffic generator: a mix file's recipes, built on the device.

A traffic mix (`portbench/traffic/<name>.json`) is data: the batch size and,
per recipe, the space each parameter is drawn from ({"choice": [...]},
{"uniform": [lo, hi]} or {"integers": [lo, hi)}). A configuration names the
recipes it uses (its `phenomenon`, `anisotropy_type` and `m_type`); the mix
gives their spaces, under "ic", "c" and "m".

A recipe is a file of its own, found by its name:

  traffic/recipes/ic/<phenomenon>.py     the initial state of a lane
  traffic/recipes/c/<anisotropy_type>.py the lane's c field
  traffic/recipes/m/<m_type>.py          the lane's m field

each with make(rng, params, X, L, cfg): X the mesh coordinates (float64 on
the device, indexing "ij"), L the half-width, cfg the configuration's
DatagenConfig fields. An ic recipe returns what the configuration's family
takes (portbench/families.py): a complex u for NLSE, (u0, v0) real for
real-wave. The recipes are frozen torch copies of the port's host samplers,
drawn to the same distributions, not the same bits; later PRs may change
the samplers, never these copies.

The few scalars of each run (positions, phases, amplitudes) come from a
numpy Generator seeded with the run's seed, in one fixed order (each lane:
the ic, c and m parameters, then the ic, c and m recipes), so a seed gives
the same inputs; every field is evaluated on the device in float64, then
handed out as float32, the dtype the sweep passes to the engine.
"""

import json
from pathlib import Path

import numpy as np
import torch

from portbench import cells, families

__all__ = ["load_mix", "make_inputs", "draw", "recipe"]

HERE = Path(__file__).resolve().parent


def load_mix(name, root=HERE):
    """The traffic mix `name` (portbench/traffic/<name>.json)."""
    path = Path(root) / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def recipe(kind, name, root=HERE):
    """The make function of recipe `name` of `kind` ("ic", "c" or "m"):
    portbench/traffic/recipes/<kind>/<name>.py."""
    path = Path(root) / "recipes" / kind / f"{name}.py"
    return cells.load_file(path, f"{kind} recipe", "portbench_recipe_" + kind
                           ).make


def draw(rng, space):
    """One concrete draw of every parameter of a recipe's space."""
    out = {}
    for key, spec in space.items():
        (kind, arg), = spec.items()
        if kind == "choice":
            out[key] = arg[int(rng.integers(len(arg)))]
        elif kind == "uniform":
            out[key] = float(rng.uniform(*arg))
        elif kind == "integers":
            out[key] = int(rng.integers(*arg))
        else:
            raise ValueError(f"unknown draw {kind!r} for {key!r}")
    return out


def _grid(nx, dim, L, device):
    """Mesh coordinates (indexing "ij", as Grid2D / Grid3D.mesh)."""
    x = torch.linspace(-L, L, nx, dtype=torch.float64, device=device)
    return torch.meshgrid(*([x] * dim), indexing="ij")


def make_inputs(mix, cfg, seed, device, root=HERE):
    """The batch of one cell: (state, m, c, metas). `state` is the tuple of
    the family's state tensors (NLSE: u0 (B, 2, *shape) packed (re, im);
    real-wave: u0 and v0, each (B, *shape)), m and c are (B, *shape), all
    float32 on `device`; metas lists each run's drawn parameters. `cfg`
    holds the configuration's DatagenConfig fields (family, dim, nx, Lx,
    phenomenon, anisotropy_type, m_type and what the recipes read)."""
    fam = families.family(cfg)
    dim, nx, L = cfg["dim"], cfg["nx"], float(cfg["Lx"])
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    X = _grid(nx, dim, L, device)
    names = (("ic", cfg["phenomenon"]), ("c", cfg["anisotropy_type"]),
             ("m", cfg["m_type"]))
    spaces = [mix[kind][name] for kind, name in names]
    make_ic, make_c, make_m = (recipe(kind, name, root)
                               for kind, name in names)
    B = mix["batch"]
    shape = (nx,) * dim
    state = None
    m = torch.empty((B,) + shape, dtype=torch.float32, device=device)
    c = torch.empty((B,) + shape, dtype=torch.float32, device=device)
    metas = []
    for b in range(B):
        pi, pc, pm = [draw(rng, space) for space in spaces]
        rows = fam.lane(make_ic(rng, pi, X, L, cfg), mix)
        cb = make_c(rng, pc, X, L, cfg)
        mb = make_m(rng, pm, X, L, cfg)
        if state is None:
            state = tuple(torch.empty((B,) + r.shape, dtype=torch.float32,
                                      device=device) for r in rows)
        for buf, r in zip(state, rows):
            buf[b] = r
        m[b], c[b] = mb, cb
        metas.append(dict(ic=pi, c=pc, m=pm))
    return state, m, c, metas
