"""3D real-wave initial-condition phenomena.

Capability parity with RealWaveSampler3d (real_sampler.py:1642-1816):
kink_field (per-axis windings) and q_ball_soliton, plus the 3D anisotropic
GRF velocity option.
"""

import numpy as np

from nlsolvers_tpu_torch.pipeline.grids import (Grid3D, gaussian_random_field,
                                          resolve_param_ranges)
from nlsolvers_tpu_torch.pipeline.samplers import common

__all__ = ["PHENOMENA", "RealWaveSampler3d"]


def kink_field(grid, rng, system_type="klein_gordon", winding_x=1,
               winding_y=0, winding_z=0, width_range=(0.5, 3.0),
               randomize_positions=True, velocity_type="zero"):
    """Sums of axis-aligned kinks in x/y/z (real_sampler.py:1713-1773)."""
    coords = grid.mesh()
    u = np.zeros_like(coords[0])
    for coord, winding in zip(coords, (winding_x, winding_y, winding_z)):
        if winding == 0:
            continue
        width = rng.uniform(*width_range)
        sign = 1 if winding > 0 else -1
        for i in range(abs(winding)):
            if randomize_positions:
                pos = grid.L * (2 * rng.random() - 1)
            else:
                pos = grid.L * (-0.8 + 1.6 * i / abs(winding))
            w = width * (0.8 + 0.4 * rng.random())
            u += sign * 4 * np.arctan(np.exp((coord - pos) / w))
    if velocity_type == "zero":
        v = np.zeros_like(u)
    else:
        v = gaussian_random_field(grid, rng,
                                  length_scale=np.mean(width_range) * 2.0,
                                  amplitude=np.max(np.abs(u)) * 0.1)
    return u, v


def q_ball_soliton(grid, rng, system_type="klein_gordon", position=None,
                   omega=0.8, amplitude=1.0, w=0.5,
                   velocity_type="fitting"):
    """Gaussian rotor blob (real_sampler.py:1775-1792)."""
    X, Y, Z = grid.mesh()
    if position is None:
        position = 0.5 * rng.uniform(-grid.L, grid.L, 3)
    xc, yc, zc = position
    R2 = (X - xc) ** 2 + (Y - yc) ** 2 + (Z - zc) ** 2
    profile = amplitude * np.exp(-R2 / (2 * w ** 2))
    u = profile * np.cos(omega)
    v = (-omega * profile * np.sin(omega) if velocity_type == "fitting"
         else np.zeros_like(u))
    return u, v


PHENOMENA = {
    "kink_field": kink_field,
    "q_ball_soliton": q_ball_soliton,
}


class RealWaveSampler3d:
    """Reference-parity API (real_sampler.py:1642-1816)."""

    def __init__(self, nx, ny, nz, L, seed=None):
        self.grid = Grid3D(nx, ny, nz, L)
        self.rng = np.random.default_rng(seed)

    def generate_sample(self, system_type="klein_gordon",
                        phenomenon_type="kink_field", **params):
        return PHENOMENA[phenomenon_type](self.grid, self.rng,
                                          system_type=system_type, **params)

    def generate_ensemble(self, system_type="klein_gordon",
                          phenomenon_type="kink_field", n_samples=10,
                          parameter_ranges=None, **fixed):
        def draw():
            params = resolve_param_ranges(self.rng, parameter_ranges, fixed)
            return self.generate_sample(system_type, phenomenon_type,
                                        **params)
        return common.ensemble(draw, n_samples)

    def generate_initial_condition(self, system_type="klein_gordon",
                                   phenomenon_type=None,
                                   velocity_type="fitting", **params):
        """Max-abs normalized u0 as the reference does
        (real_sampler.py:1804-1816)."""
        if phenomenon_type is None:
            raise ValueError("phenomenon_type is required")
        u0, v0 = self.generate_sample(system_type, phenomenon_type,
                                      velocity_type=velocity_type, **params)
        return u0 / np.max(np.abs(u0) + 1e-10), v0
