"""Bright-soliton superpositions, the arithmetic of the multi_soliton and
multi_soliton_state recipes (recipes/ic/): a frozen torch copy of the
port's host samplers, drawn to the same distributions, not the same bits:

  multi_soliton, multi_soliton_state  pipeline/samplers/nlse2d.py:66-116,
                                      samplers/nlse3d.py:56-110, with
                                      samplers/common.py's arrangements and
                                      phase patterns
"""

import math

import numpy as np
import torch

__all__ = ["soliton_state"]

GOLDEN = math.pi * (1 + 5 ** 0.5)


def _fib_sphere(i, n):
    phi = math.acos(1 - 2 * i / n)
    theta = GOLDEN * i
    return [math.sin(phi) * math.cos(theta), math.sin(phi) * math.sin(theta),
            math.cos(phi)]


def _positions(rng, n, p, L, dim):
    """Centers of n solitons (samplers/common.arrange_positions)."""
    arr, sep = p["arrangement"], p["separation"]
    pad = [0.0] * (dim - 2)
    if arr == "linear":
        pts = [[(i - (n - 1) / 2) * sep] + [0.0] * (dim - 1)
               for i in range(n)]
    elif arr == "circular":
        pts = [[sep * math.cos(2 * math.pi * i / n),
                sep * math.sin(2 * math.pi * i / n)] + pad for i in range(n)]
    elif (arr == "lattice" and dim == 2) or arr == "planar_grid":
        side = math.ceil(math.sqrt(n))
        pts = [[(i - (side - 1) / 2) * sep, (j - (side - 1) / 2) * sep] + pad
               for i in range(side) for j in range(side)]
    elif arr == "lattice":
        side = math.ceil(n ** (1 / 3))
        pts = [[(i - (side - 1) / 2) * sep, (j - (side - 1) / 2) * sep,
                (k - (side - 1) / 2) * sep]
               for i in range(side) for j in range(side) for k in range(side)]
    elif arr == "spherical":
        pts = [[sep * c for c in _fib_sphere(i, n)] for i in range(n)]
    elif arr == "hierarchical":
        levels = p["cluster_levels"]
        if levels <= 1:
            centers = [[0.0] * dim]
        elif dim == 2:
            centers = [[2 * sep * math.cos(2 * math.pi * i / levels),
                        2 * sep * math.sin(2 * math.pi * i / levels)]
                       for i in range(levels)]
        else:
            centers = [[2 * sep * c for c in _fib_sphere(i, levels)]
                       for i in range(levels)]
        per, rem = divmod(n, len(centers))
        pts = []
        for ci, c in enumerate(centers):
            size = per + (1 if ci < rem else 0)
            for j in range(size):
                if j == 0 and levels > 1:
                    pts.append(list(c))
                elif dim == 2:
                    a = 2 * math.pi * j / size
                    pts.append([c[0] + 0.5 * sep * math.cos(a),
                                c[1] + 0.5 * sep * math.sin(a)])
                else:
                    pts.append([x + 0.5 * sep * o
                                for x, o in zip(c, _fib_sphere(j, size))])
    elif arr == "random":
        pts = rng.normal(0.0, p["position_variance"] * L / 4,
                         (n, dim)).tolist()
    else:
        raise ValueError(f"unknown arrangement {arr!r}")
    return np.asarray(pts[:n], float)


def _phases(rng, pos, p):
    """Per-soliton phases (samplers/common.assign_phases)."""
    n, pat = len(pos), p["phase_pattern"]
    rel = pos - pos.mean(axis=0)
    if pat == "random":
        return rng.uniform(0, 2 * np.pi, n)
    if pat == "alternating":
        return np.arange(n) * np.pi
    if pat == "synchronized":
        return np.full(n, p["phase_value"])
    if pat == "vortex":
        return np.arctan2(rel[:, 1], rel[:, 0])
    if pat == "3d_vortex":
        r = np.linalg.norm(rel, axis=1)
        return (np.arctan2(rel[:, 1], rel[:, 0])
                + np.arccos(rel[:, 2] / np.maximum(r, 1e-10)))
    if pat == "radial":
        return np.linalg.norm(rel, axis=1)
    if pat == "spiral":
        return np.arctan2(rel[:, 1], rel[:, 0]) + np.linalg.norm(rel, axis=1)
    if pat == "z_dependent":
        return rel[:, 2].copy()
    if pat == "partial_coherence":
        base = rng.uniform(0, 2 * np.pi)
        return np.where(rng.random(n) < p["coherence"], base,
                        rng.uniform(0, 2 * np.pi, n))
    raise ValueError(f"unknown phase pattern {pat!r}")


def _profile(system, r, width, amp, Lam, order):
    """Radial bright-soliton profile (samplers/nlse2d.soliton_profile, with
    its defaults sigma1 = 1, sigma2 = -0.1, kappa = 1)."""
    if system == "glasner_allen_flowers":
        core = 1.0 / torch.cosh(math.sqrt(Lam) * r) ** order
        inner = core ** (2 / order) if order != 1 else core ** 2
        return amp * core / torch.sqrt(9 - 48 * Lam * inner + 31)
    core = 1.0 / torch.cosh(r / width) ** order
    if system == "cubic_quintic":
        beta = 0.1 * amp ** 2
        return amp * core / torch.sqrt(1 + beta * core ** 2)
    if system == "saturable":
        return amp * core / torch.sqrt(1 + amp ** 2 * core ** 2)
    if system == "cubic":
        return amp * core
    raise ValueError(f"unknown soliton system {system!r}")


def _rotated(X, pos, rng, dim):
    """Coordinates relative to `pos`, rotated by random plane angles (one
    angle in 2D, the xy, xz, yz sequence in 3D), and those angles drawn."""
    rel = [X[d] - pos[d] for d in range(dim)]
    if dim == 2:
        a = rng.uniform(0, 2 * np.pi)
        c, s = math.cos(a), math.sin(a)
        return [rel[0] * c + rel[1] * s, -rel[0] * s + rel[1] * c]
    axy, axz, ayz = (rng.uniform(0, 2 * np.pi) for _ in range(3))
    x1 = rel[0] * math.cos(axy) + rel[1] * math.sin(axy)
    y1 = -rel[0] * math.sin(axy) + rel[1] * math.cos(axy)
    x2 = x1 * math.cos(axz) + rel[2] * math.sin(axz)
    z2 = -x1 * math.sin(axz) + rel[2] * math.cos(axz)
    return [x2, y1 * math.cos(ayz) + z2 * math.sin(ayz),
            -y1 * math.sin(ayz) + z2 * math.cos(ayz)]


def soliton_state(rng, p, X, L):
    """A superposition of bright solitons (multi_soliton in 2D,
    multi_soliton_state in 3D), complex128 on X's device."""
    dim = len(X)
    n = p["n_solitons"]
    pos = _positions(rng, n, p, L, dim)
    phases = _phases(rng, pos, p)
    u = torch.zeros(X[0].shape, dtype=torch.complex128, device=X[0].device)
    for i, (q, ph) in enumerate(zip(pos, phases)):
        vs = p["velocity_scale"]
        if vs <= 0:
            vel = [0.0] * dim
        elif p["arrangement"] == "spherical" and dim == 3:
            nrm = float(np.linalg.norm(q))
            vel = ([-vs * x / nrm for x in q] if nrm > 1e-10
                   else [0.0] * dim)
        elif p["arrangement"] == "circular":
            a = 2 * np.pi * i / n
            vel = [-vs * math.cos(a), -vs * math.sin(a)] + [0.0] * (dim - 2)
        else:
            vel = rng.normal(0, vs, dim).tolist()
        amp = rng.uniform(*p["amplitude_range"])
        width = rng.uniform(*p["width_range"])
        Lam = rng.uniform(*p["Lambda_range"])
        chirp = rng.uniform(*p["chirp_range"])
        if dim == 2:
            aspect = [rng.uniform(*p["aspect_ratio_range"]), 1.0]
        else:
            aspect = [rng.uniform(*p["aspect_ratio_x_range"]),
                      rng.uniform(*p["aspect_ratio_y_range"]), 1.0]
        R = _rotated(X, q, rng, dim)
        order = int(rng.integers(*p["order_range"]))
        r = torch.sqrt(sum((Rd / a) ** 2 for Rd, a in zip(R, aspect)))
        prof = _profile(p["system_type"], r, width, amp, Lam, order)
        phase = sum(v * (X[d] - q[d]) for d, v in enumerate(vel))
        phase = phase + ph + chirp * r * r
        comp = prof * torch.exp(1j * phase)
        s = p["interaction_strength"]
        u = u + (s * comp if (s < 1.0 and i > 0) else comp)
    return u
