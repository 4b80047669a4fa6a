"""3D NLSE initial-condition phenomena.

Capability parity with NLSE3DSampler (nlse_sampler.py:750-1190):
multi_soliton_state (3D arrangements + 3D phase patterns) and skyrmion_tube.
"""

import numpy as np

from nlsolvers_tpu_torch.pipeline.grids import Grid3D, resolve_param_ranges
from nlsolvers_tpu_torch.pipeline.samplers import common
from nlsolvers_tpu_torch.pipeline.samplers.nlse2d import soliton_profile

__all__ = ["PHENOMENA", "NLSE3DSampler"]


def _rotate3d(X, Y, Z, center, angles):
    """Sequential xy, xz, yz plane rotations about `center`
    (nlse_sampler.py:794-804)."""
    x0, y0, z0 = center
    axy, axz, ayz = angles
    X1 = (X - x0) * np.cos(axy) + (Y - y0) * np.sin(axy)
    Y1 = -(X - x0) * np.sin(axy) + (Y - y0) * np.cos(axy)
    Z1 = Z - z0
    X2 = X1 * np.cos(axz) + Z1 * np.sin(axz)
    Z2 = -X1 * np.sin(axz) + Z1 * np.cos(axz)
    Y3 = Y1 * np.cos(ayz) + Z2 * np.sin(ayz)
    Z3 = -Y1 * np.sin(ayz) + Z2 * np.cos(ayz)
    return X2, Y3, Z3


def fundamental_soliton_3d(grid, rng, system_type="cubic", amplitude=1.0,
                           width=1.0, position=(0, 0, 0), phase=0.2,
                           velocity=(0.0, 0.0, 0.0), sigma1=1.0, sigma2=-0.1,
                           kappa=1.0, apply_envelope=True,
                           envelope_width=0.7, Lambda=0.1, chirp_factor=0.0,
                           aspect_ratio_x=1.0, aspect_ratio_y=1.0,
                           orientation_xy=0.0, orientation_xz=0.0,
                           orientation_yz=0.0, order=1):
    """3D bright soliton with triple-plane orientation
    (nlse_sampler.py:786-853)."""
    X, Y, Z = grid.mesh()
    Xr, Yr, Zr = _rotate3d(X, Y, Z, position,
                           (orientation_xy, orientation_xz, orientation_yz))
    r_local = np.sqrt((Xr / aspect_ratio_x) ** 2
                      + (Yr / aspect_ratio_y) ** 2 + Zr ** 2)
    profile = soliton_profile(system_type, r_local, width, amplitude,
                              sigma1, sigma2, kappa, Lambda, order)
    total_phase = (velocity[0] * (X - position[0])
                   + velocity[1] * (Y - position[1])
                   + velocity[2] * (Z - position[2])
                   + phase + chirp_factor * r_local ** 2)
    u = profile * np.exp(1j * total_phase)
    return grid.envelope(u, envelope_width) if apply_envelope else u


def multi_soliton_state(grid, rng, system_type="cubic",
                        amplitude_range=(0.8, 1.2), width_range=(0.8, 1.2),
                        position_variance=1.0, velocity_scale=1.0,
                        phase_pattern="vortex", arrangement="random",
                        separation=5.0, sigma1=1.0, sigma2=-0.1, kappa=1.0,
                        apply_envelope=False, envelope_width=0.7,
                        Lambda_range=(0.04, 0.14), coherence=0.8,
                        interaction_strength=0.5, cluster_levels=1,
                        order_range=(1, 2), chirp_range=(-0.1, 0.1),
                        aspect_ratio_x_range=(1.0, 1.5),
                        aspect_ratio_y_range=(1.0, 1.5), phase_value=0.0,
                        n_solitons=None):
    """2-5 solitons in 3D arrangements (spherical / lattice / hierarchical /
    ... ) with 3D phase patterns (nlse_sampler.py:855-1052)."""
    n = n_solitons if n_solitons is not None else int(rng.integers(2, 6))
    positions = common.arrange_positions(
        rng, n, arrangement, grid.L, separation=separation,
        position_variance=position_variance, cluster_levels=cluster_levels,
        dim=3)
    phases = common.assign_phases(rng, positions, phase_pattern,
                                  coherence=coherence,
                                  phase_value=phase_value)
    u = np.zeros((grid.nx, grid.ny, grid.nz), complex)
    for i, (p, ph) in enumerate(zip(positions, phases)):
        if velocity_scale > 0:
            if arrangement == "spherical":
                norm = np.linalg.norm(p)
                vel = tuple(-velocity_scale * p / norm) if norm > 1e-10 \
                    else (0.0, 0.0, 0.0)
            elif arrangement == "circular":
                a = 2 * np.pi * i / n
                vel = (-velocity_scale * np.cos(a),
                       -velocity_scale * np.sin(a), 0.0)
            else:
                vel = tuple(rng.normal(0, velocity_scale, 3))
        else:
            vel = (0.0, 0.0, 0.0)
        comp = fundamental_soliton_3d(
            grid, rng, system_type,
            amplitude=rng.uniform(*amplitude_range),
            width=rng.uniform(*width_range), position=tuple(p), phase=ph,
            velocity=vel, sigma1=sigma1, sigma2=sigma2, kappa=kappa,
            apply_envelope=False, Lambda=rng.uniform(*Lambda_range),
            chirp_factor=rng.uniform(*chirp_range),
            aspect_ratio_x=rng.uniform(*aspect_ratio_x_range),
            aspect_ratio_y=rng.uniform(*aspect_ratio_y_range),
            orientation_xy=rng.uniform(0, 2 * np.pi),
            orientation_xz=rng.uniform(0, 2 * np.pi),
            orientation_yz=rng.uniform(0, 2 * np.pi),
            order=int(rng.integers(*order_range)))
        u = u + (interaction_strength * comp
                 if (interaction_strength < 1.0 and i > 0) else comp)
    return grid.envelope(u, envelope_width) if apply_envelope else u


def skyrmion_tube(grid, rng, system_type="cubic", amplitude_range=(0.8, 1.5),
                  radius_range=(1.0, 3.0), width_range=(0.5, 1.5),
                  position_variance=0.5, phase_range=(0, 2 * np.pi),
                  winding_range=(1, 3), k_z_range=(0.1, 1.0),
                  velocity_scale=0.3, chirp_range=(-0.1, 0.1),
                  tube_count_range=(1, 5), apply_envelope=True,
                  envelope_width=0.7, tube_arrangement="random",
                  interaction_strength=0.5, deformation_factor=0.2):
    """Azimuthally wound, z-twisted vortex tubes with deformed cores
    (nlse_sampler.py:1054-1137)."""
    X, Y, Z = grid.mesh()
    n_tubes = int(rng.integers(*tube_count_range))
    if tube_arrangement == "circular":
        R = grid.L / 4
        positions = [(R * np.cos(2 * np.pi * i / n_tubes),
                      R * np.sin(2 * np.pi * i / n_tubes), 0.0)
                     for i in range(n_tubes)]
    elif tube_arrangement == "linear":
        sp = grid.L / 3
        positions = [((i - (n_tubes - 1) / 2) * sp, 0.0, 0.0)
                     for i in range(n_tubes)]
    elif tube_arrangement == "lattice":
        side = int(np.ceil(np.sqrt(n_tubes)))
        sp = grid.L / 4
        positions = [((i - (side - 1) / 2) * sp, (j - (side - 1) / 2) * sp,
                      0.0)
                     for i in range(side) for j in range(side)][:n_tubes]
    else:
        positions = [(rng.normal(0, position_variance * grid.L / 4),
                      rng.normal(0, position_variance * grid.L / 4), 0.0)
                     for _ in range(n_tubes)]
    u = np.zeros_like(X, dtype=complex)
    for i, (x0, y0, z0) in enumerate(positions):
        amplitude = rng.uniform(*amplitude_range)
        radius = rng.uniform(*radius_range)
        width = rng.uniform(*width_range)
        phase = rng.uniform(*phase_range)
        winding = int(rng.integers(*winding_range))
        k_z = rng.uniform(*k_z_range)
        chirp = rng.uniform(*chirp_range)
        vel = (rng.normal(0, velocity_scale, 3) if velocity_scale > 0
               else np.zeros(3))
        rho = np.sqrt((X - x0) ** 2 + (Y - y0) ** 2)
        phi = np.arctan2(Y - y0, X - x0)
        deform = 1.0 + deformation_factor * np.cos(
            phi * rng.integers(1, 4))
        profile = amplitude * np.exp(
            -((rho - radius * deform) ** 2 + (Z - z0) ** 2) / width ** 2)
        mom = vel[0] * (X - x0) + vel[1] * (Y - y0) + vel[2] * (Z - z0)
        chirp_term = chirp * ((X - x0) ** 2 + (Y - y0) ** 2 + (Z - z0) ** 2)
        comp = profile * np.exp(
            1j * (winding * phi + k_z * (Z - z0) + phase + mom + chirp_term))
        u = u + (interaction_strength * comp
                 if (interaction_strength < 1.0 and i > 0) else comp)
    return grid.envelope(u, envelope_width) if apply_envelope else u


PHENOMENA = {
    "multi_soliton_state": multi_soliton_state,
    "skyrmion_tube": skyrmion_tube,
    "fundamental_soliton": fundamental_soliton_3d,
}


class NLSE3DSampler:
    """Reference-parity API (nlse_sampler.py:750-1190)."""

    def __init__(self, nx, ny, nz, L, seed=None):
        self.grid = Grid3D(nx, ny, nz, L)
        self.rng = np.random.default_rng(seed)

    def generate_sample(self, phenomenon_type, system_type="cubic",
                        **params):
        return PHENOMENA[phenomenon_type](self.grid, self.rng,
                                          system_type=system_type, **params)

    def generate_ensemble(self, phenomenon_type, system_type="cubic",
                          n_samples=10, parameter_ranges=None, **fixed):
        def draw():
            params = resolve_param_ranges(self.rng, parameter_ranges, fixed)
            return self.generate_sample(phenomenon_type, system_type,
                                        **params)
        return common.ensemble(draw, n_samples)

    def generate_initial_condition(self, system_type="cubic",
                                   phenomenon_type=None, **params):
        """Max-abs normalized single sample (nlse_sampler.py:1174-1190)."""
        if phenomenon_type is None:
            raise ValueError("phenomenon_type is required")
        u0 = self.generate_sample(phenomenon_type, system_type, **params)
        return u0 / np.max(np.abs(u0))
