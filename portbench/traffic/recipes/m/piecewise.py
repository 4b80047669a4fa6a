"""m piecewise: a two-level mass, m0 and m2_factor * m0, with a
tanh-smoothed interface (a frozen torch copy of the port's
pipeline/fields.py:206-227); m0 is the configuration's (1 by default)."""

import torch


def make(rng, p, X, L, cfg):
    del rng
    m0 = cfg.get("m0", 1.0)
    kind, bp = p["boundary_type"], p["boundary_param"]
    if kind in ("circle", "sphere"):
        b = torch.sqrt(sum(x * x for x in X)) - bp * L
    elif kind == "square":
        b = torch.stack([x.abs() for x in X]).amax(dim=0) - bp * L
    elif kind == "horizontal":
        b = X[1 % len(X)]
    elif kind == "vertical":
        b = X[0]
    elif kind == "diagonal":
        b = sum(X)
    else:
        raise ValueError(f"unknown boundary {kind!r}")
    m2 = p["m2_factor"] * m0
    return m0 + (m2 - m0) * 0.5 * (1 + torch.tanh(b / (p["smooth_width"] * L)))
