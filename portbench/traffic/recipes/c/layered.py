"""c layered: superposed randomly oriented plane-wave layers, min-max
normalized to [0, 1] (a frozen torch copy of the port's
pipeline/fields.py:75-89, drawn to the same distribution)."""

import numpy as np
import torch

BASE = 1.0


def make(rng, p, X, L, cfg):
    del L, cfg
    dim = len(X)
    prof = torch.full_like(X[0], BASE)
    for _ in range(p["num_layers"]):
        d = rng.standard_normal(dim)
        d /= np.linalg.norm(d)
        proj = sum(float(dk) * Xk for dk, Xk in zip(d, X))
        amp = rng.uniform(p["min_amplitude"], p["max_amplitude"])
        freq = rng.uniform(p["min_freq"], p["max_freq"])
        ph = rng.uniform(0, 2 * np.pi)
        prof = prof + amp * torch.sin(freq * proj + ph)
    lo, hi = prof.min(), prof.max()
    return BASE * (prof - lo) / (hi - lo)
