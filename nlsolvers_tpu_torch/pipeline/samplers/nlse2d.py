"""2D NLSE initial-condition phenomena (complex fields).

Capability parity with finalized_scripts/nlse_sampler.py:9-748
(NLSEPhenomenonSampler): fundamental/multi soliton (system-aware profiles),
Akhmediev breather, vortex (+lattice), ring (+multi-ring), turbulent
condensate. Registry functions take (grid, rng, ...) and return a complex
(nx, ny) array; NLSEPhenomenonSampler keeps the reference class API.
"""

import numpy as np

from nlsolvers_tpu_torch.pipeline.grids import (Grid2D, resolve_param_ranges,
                                          rotate2d, sech)
from nlsolvers_tpu_torch.pipeline.samplers import common

__all__ = ["PHENOMENA", "NLSEPhenomenonSampler", "soliton_profile"]

SYSTEM_TYPES = ("cubic", "cubic_quintic", "saturable",
                "glasner_allen_flowers")


def soliton_profile(system_type, r, width, amplitude, sigma1=1.0,
                    sigma2=-0.1, kappa=1.0, Lambda=0.1, order=1):
    """Radial bright-soliton profile per NLSE variant
    (nlse_sampler.py:59-93). `order` powers the sech core."""
    if system_type == "cubic":
        return amplitude * sech(r / width) ** order
    if system_type == "cubic_quintic":
        beta = -sigma2 * amplitude ** 2 / sigma1
        core = sech(r / width) ** order
        if beta > 0:
            return amplitude * core / np.sqrt(1 + beta * core ** 2)
        return amplitude * core
    if system_type == "saturable":
        core = sech(r / width) ** order
        return amplitude * core / np.sqrt(
            1 + kappa * amplitude ** 2 * core ** 2)
    if system_type == "glasner_allen_flowers":
        # sech-core ansatz from Glasner-Allen-Flowers; the constant 40 floor
        # (9 + 31) keeps the denominator positive for Lambda < ~0.8
        core = sech(np.sqrt(Lambda) * r) ** order
        inner = core ** (2 / order) if order != 1 else core ** 2
        return amplitude * core / np.sqrt(9 - 48 * Lambda * inner + 31)
    raise ValueError(f"unknown NLSE system type {system_type!r}")


def fundamental_soliton(grid, rng, system_type="cubic", amplitude=1.0,
                        width=1.0, position=(0.0, 0.0), phase=0.2,
                        velocity=(0.0, 0.0), sigma1=1.0, sigma2=-0.1,
                        kappa=1.0, apply_envelope=True, envelope_width=0.7,
                        Lambda=0.1, chirp_factor=0.0, aspect_ratio=1.0,
                        orientation=0.0, order=1):
    """Single moving, chirped, elliptical soliton (nlse_sampler.py:43-100)."""
    X, Y = grid.mesh()
    Xr, Yr = rotate2d(X, Y, *position, angle=orientation)
    r_local = np.sqrt((Xr / aspect_ratio) ** 2 + Yr ** 2)
    profile = soliton_profile(system_type, r_local, width, amplitude,
                              sigma1, sigma2, kappa, Lambda, order)
    total_phase = (velocity[0] * (X - position[0])
                   + velocity[1] * (Y - position[1])
                   + phase + chirp_factor * r_local ** 2)
    u = profile * np.exp(1j * total_phase)
    return grid.envelope(u, envelope_width) if apply_envelope else u


def multi_soliton(grid, rng, system_type="cubic", amplitude_range=(0.8, 1.2),
                  width_range=(0.8, 1.2), position_variance=1.0,
                  velocity_scale=1.0, phase_pattern="vortex",
                  arrangement="random", separation=5.0, sigma1=1.0,
                  sigma2=-0.1, kappa=1.0, apply_envelope=False,
                  envelope_width=0.7, Lambda_range=(0.04, 0.14),
                  coherence=0.8, interaction_strength=0.5, cluster_levels=1,
                  order_range=(1, 2), chirp_range=(-0.1, 0.1),
                  aspect_ratio_range=(1.0, 1.5), n_solitons=None):
    """3-11 arranged solitons with per-soliton randomized shape
    (nlse_sampler.py:102-219)."""
    n = n_solitons if n_solitons is not None else int(rng.integers(3, 12))
    positions = common.arrange_positions(
        rng, n, arrangement, grid.L, separation=separation,
        position_variance=position_variance, cluster_levels=cluster_levels)
    phases = common.assign_phases(rng, positions, phase_pattern,
                                  coherence=coherence)
    u = np.zeros((grid.nx, grid.ny), complex)
    for i, ((x0, y0), ph) in enumerate(zip(positions, phases)):
        if velocity_scale > 0:
            if arrangement == "circular":   # converging rendezvous
                a = 2 * np.pi * i / n
                vel = (-velocity_scale * np.cos(a),
                       -velocity_scale * np.sin(a))
            else:
                vel = tuple(rng.normal(0, velocity_scale, 2))
        else:
            vel = (0.0, 0.0)
        comp = fundamental_soliton(
            grid, rng, system_type,
            amplitude=rng.uniform(*amplitude_range),
            width=rng.uniform(*width_range), position=(x0, y0), phase=ph,
            velocity=vel, sigma1=sigma1, sigma2=sigma2, kappa=kappa,
            apply_envelope=False, Lambda=rng.uniform(*Lambda_range),
            chirp_factor=rng.uniform(*chirp_range),
            aspect_ratio=rng.uniform(*aspect_ratio_range),
            orientation=rng.uniform(0, 2 * np.pi),
            order=int(rng.integers(*order_range)))
        u = u + (interaction_strength * comp
                 if (interaction_strength < 1.0 and i > 0) else comp)
    return grid.envelope(u, envelope_width) if apply_envelope else u


def akhmediev_breather(grid, rng, amplitude=1.0, modulation_frequency=1.0,
                       growth_rate=0.5, position=None, phase=None,
                       orientation=None, breather_phase="compressed",
                       apply_envelope=False, envelope_width=0.7,
                       aspect_ratio=1.0, t_param=None):
    """Akhmediev breather frozen at evolution coordinate z
    (nlse_sampler.py:221-268); growth rate a in (0, 1/2)."""
    if position is None:
        position = rng.normal(0, grid.L / 4, 2)
    if phase is None:
        phase = rng.random() * 1j
    if orientation is None:
        orientation = rng.random() * np.pi
    if t_param is None:
        t_param = rng.random()
    X, Y = grid.mesh()
    Xr, Yr = rotate2d(X, Y, *position, angle=float(orientation))
    Xs = Xr / aspect_ratio
    a = np.clip(growth_rate, 0.001, 0.499)
    b = np.sqrt(8 * a * (1 - 2 * a))
    z = {"compressed": 0.0, "growing": -1.0,
         "decaying": 1.0}.get(breather_phase, None)
    z = float(breather_phase) if z is None else z
    cosx = np.cos(modulation_frequency * Xs)
    num = ((1 - 4 * a) * np.cosh(b * z) + np.sqrt(2 * a) * cosx
           + 1j * b * np.sinh(b * z))
    den = 2 * a * cosx - np.cosh(b * z)
    u = amplitude * num / den * np.exp(1j * (t_param + phase))
    if apply_envelope:
        u = u * np.exp(-Yr ** 2 / (2 * envelope_width ** 2))
    return u.astype(complex)


def vortex(grid, rng, amplitude=1.0, position=(0.0, 0.0), charge=1,
           core_size=1.0, apply_envelope=True, envelope_width=0.7,
           eccentricity=1.0, orientation=0.0, radial_mode=0):
    """tanh-core vortex with winding phase (nlse_sampler.py:270-296)."""
    X, Y = grid.mesh()
    Xr, Yr = rotate2d(X, Y, *position, angle=orientation)
    r_local = np.sqrt((Xr / eccentricity) ** 2 + Yr ** 2)
    theta_local = np.arctan2(Y - position[1], X - position[0])
    profile = amplitude * np.tanh(r_local / core_size)
    if radial_mode > 0:
        profile = profile * (1 - np.exp(-(r_local
                                          / (radial_mode * core_size)) ** 2))
        for i in range(1, radial_mode + 1):
            profile = profile * (r_local / core_size - i * np.pi) ** 2
        profile = np.abs(profile) / np.max(np.abs(profile)) * amplitude
    u = profile * np.exp(1j * charge * theta_local)
    return grid.envelope(u, envelope_width) if apply_envelope else u


def vortex_lattice(grid, rng, amplitude=1.0, n_vortices=5,
                   arrangement="random", separation=2.0,
                   charge_distribution="alternating", apply_envelope=True,
                   envelope_width=0.8, eccentricity=1.0,
                   core_size_range=(0.5, 1.5), radial_mode=0):
    """Multiplicative vortex product (condensate ansatz), max-normalized
    (nlse_sampler.py:298-380)."""
    if arrangement in ("square", "triangular", "circular", "quasicrystal"):
        positions = common.arrange_positions(rng, n_vortices, arrangement,
                                             grid.L, separation=separation)
    else:
        positions = rng.uniform(-grid.L / 3, grid.L / 3, (n_vortices, 2))
    if charge_distribution == "alternating":
        charges = [(i % 2) * 2 - 1 for i in range(n_vortices)]
    elif charge_distribution == "same":
        charges = [rng.choice([-1, 1])] * n_vortices
    elif charge_distribution == "fractional":
        charges = [rng.uniform(0.5, 1.5) * rng.choice([-1, 1])] * n_vortices
    else:
        charges = rng.choice([-1, 1], n_vortices)
    X, Y = grid.mesh()
    u = np.ones_like(X, dtype=complex)
    for (x0, y0), q in zip(positions, charges):
        r = np.sqrt((X - x0) ** 2 + (Y - y0) ** 2)
        theta = np.arctan2(Y - y0, X - x0)
        core = rng.uniform(*core_size_range)
        profile = (r / core) / np.sqrt(r ** 2 + core ** 2)
        for i in range(1, radial_mode + 1):
            profile = profile * (r / core - i * np.pi) ** 2
        u = u * profile * np.exp(1j * q * theta)
    u = amplitude * u / np.max(np.abs(u))
    return grid.envelope(u, envelope_width) if apply_envelope else u


def ring_soliton(grid, rng, amplitude=1.0, radius=3.0, width=0.5,
                 position=None, phase=0.0, apply_envelope=False,
                 envelope_width=0.7, modulation_type="none",
                 modulation_strength=0.0, modulation_mode=0,
                 aspect_ratio=1.0, orientation=0.0, radial_nodes=0):
    """Gaussian annulus with azimuthal/radial modulation and optional nodes
    (nlse_sampler.py:383-415)."""
    if position is None:
        position = rng.random(2) * grid.L / 3
    X, Y = grid.mesh()
    Xr, Yr = rotate2d(X, Y, *position, angle=orientation)
    r_local = np.sqrt((Xr / aspect_ratio) ** 2 + Yr ** 2)
    theta_local = np.arctan2(Yr, Xr)
    profile = amplitude * np.exp(-(r_local - radius) ** 2 / (2 * width ** 2))
    if modulation_type == "azimuthal":
        profile = profile * (1 + modulation_strength
                             * np.cos(modulation_mode * theta_local))
    elif modulation_type == "radial":
        profile = profile * (1 + modulation_strength
                             * np.cos(modulation_mode * np.pi * r_local
                                      / radius))
    if radial_nodes > 0:
        for i in range(radial_nodes):
            profile = profile * (r_local - radius * (i + 1)
                                 / (radial_nodes + 1)) ** 2
        profile = profile / np.max(profile) * amplitude
    u = profile * np.exp(1j * phase)
    return grid.envelope(u, envelope_width) if apply_envelope else u


def multi_ring(grid, rng, amplitude_range=(0.8, 1.2),
               radius_range=(1.0, 5.0), width_range=(0.3, 0.8),
               position_variance=1.0, phase_pattern="random",
               arrangement="random", separation=5.0, apply_envelope=False,
               envelope_width=0.7, modulation_type="none",
               modulation_strength=0.0, modulation_mode=0,
               aspect_ratio_range=(1.0, 1.5), orientation_range=(0, 2 * np.pi),
               radial_nodes_range=(0, 2), n_rings=None):
    """Standard/chirped/phase-modulated rings with pairwise interaction
    phase and an overall vortex factor for closed arrangements
    (nlse_sampler.py:417-549)."""
    n = n_rings if n_rings is not None else int(rng.integers(3, 6))
    positions = common.arrange_positions(
        rng, n, arrangement, grid.L, separation=separation,
        position_variance=position_variance)
    phases = common.assign_phases(rng, positions, phase_pattern)
    X, Y = grid.mesh()
    u = np.zeros_like(X, dtype=complex)
    interaction = np.zeros_like(X)
    for i, ((x0, y0), ph) in enumerate(zip(positions, phases)):
        if arrangement == "concentric":
            radius = (i + 1) * (radius_range[1] - radius_range[0]) / n \
                + radius_range[0]
        else:
            radius = rng.uniform(*radius_range)
        width = rng.uniform(*width_range)
        kind = rng.choice(["standard", "chirped", "modulated"])
        comp = ring_soliton(
            grid, rng, amplitude=rng.uniform(*amplitude_range),
            radius=radius, width=width, position=(x0, y0), phase=ph,
            apply_envelope=False,
            modulation_type=(modulation_type if modulation_type != "none"
                             else "azimuthal"),
            modulation_strength=(modulation_strength
                                 if modulation_strength > 0 else 0.2),
            modulation_mode=(modulation_mode if modulation_mode > 0
                             else i % 3 + 1),
            aspect_ratio=rng.uniform(*aspect_ratio_range),
            orientation=rng.uniform(*orientation_range),
            radial_nodes=int(rng.integers(*radial_nodes_range)))
        r_local = np.sqrt((X - x0) ** 2 + (Y - y0) ** 2)
        theta_local = np.arctan2(Y - y0, X - x0)
        if kind == "chirped":
            comp = comp * np.exp(1j * rng.uniform(0.05, 0.4)
                                 * (r_local - radius) ** 2)
        elif kind == "modulated":
            pm = 0.3 * np.sin((i % 4 + 1) * theta_local) \
                * np.sin((i % 3 + 1) * np.pi * (r_local - radius) / width)
            comp = comp * np.exp(1j * pm)
        u = u + comp
        if i < n - 1:
            nx0, ny0 = positions[i + 1]
            interaction += 0.2 * np.exp(
                -(r_local - radius) ** 2 / (2 * width ** 2)) * np.exp(
                -((X - nx0) ** 2 + (Y - ny0) ** 2) / (4 * radius ** 2))
    if np.abs(np.sum(interaction)) < 1e-2:
        u = u * np.exp(1j * interaction)
    if arrangement in ("concentric", "circular"):
        cx, cy = positions.mean(axis=0)
        u = u * (0.7 + 0.3 * np.exp(1j * np.arctan2(Y - cy, X - cx)))
    return grid.envelope(u, envelope_width) if apply_envelope else u


def turbulent_condensate(grid, rng, amplitude=1.0, condensate_fraction=0.5,
                         temperature=1.0, n_modes=100, k_min=0.5, k_max=8.0,
                         spectrum_slope=-2.0, apply_envelope=True,
                         envelope_width=0.7, condensate_phase=None,
                         modulation_type="none", modulation_strength=0.2,
                         modulation_scale=2.0):
    """Uniform condensate + thermal fluctuations with power-law spectrum;
    built in k-space vectorized (the reference loops over all nx*ny modes
    in Python, nlse_sampler.py:574-584)."""
    if condensate_phase is None:
        condensate_phase = rng.uniform(0, 2 * np.pi)
    X, Y = grid.mesh()
    cond_amp = amplitude * np.sqrt(condensate_fraction)
    thermal_amp = amplitude * np.sqrt(1 - condensate_fraction)
    condensate = np.full_like(X, cond_amp) * np.exp(1j * condensate_phase)
    if modulation_type == "spatial":
        condensate = condensate * (
            1 + modulation_strength * np.cos(2 * np.pi * X / modulation_scale)
            * np.cos(2 * np.pi * Y / modulation_scale))
    elif modulation_type == "phase":
        condensate = condensate * np.exp(
            1j * modulation_strength * np.sin(2 * np.pi * X / modulation_scale)
            * np.sin(2 * np.pi * Y / modulation_scale))
    KX, KY = grid.kmesh()
    k_mag = np.sqrt(KX ** 2 + KY ** 2)
    in_band = (k_mag >= k_min) & (k_mag <= k_max)
    in_band[0, 0] = False
    with np.errstate(divide="ignore", invalid="ignore"):
        T_k = temperature / (1 + (k_mag / k_min) ** (-spectrum_slope))
    u_k = np.where(in_band,
                   np.sqrt(T_k) * np.exp(1j * rng.uniform(
                       0, 2 * np.pi, X.shape)), 0.0)
    thermal = np.fft.ifft2(u_k)
    thermal = thermal / np.std(np.abs(thermal)) * thermal_amp
    u = condensate + thermal
    return grid.envelope(u, envelope_width) if apply_envelope else u


def colliding_packets(grid, rng, amplitude1=1.0, amplitude2=1.0,
                      x01=None, x02=None, sigma_x=None, sigma_y=None,
                      kx1=5.0, kx2=-5.0):
    """Two counter-propagating Gaussian wavepackets — the integrator study's
    hardcoded IC (compare_utils_complex_2d.py:196-231, "colliding_packets_
    nlse"). Deterministic given its parameters; rng accepted for registry
    signature parity. Defaults mirror the reference: centers at +-L/3,
    widths L/8, carrier wavenumbers +-5."""
    L = grid.L
    x01 = -L / 3.0 if x01 is None else x01
    x02 = L / 3.0 if x02 is None else x02
    sigma_x = L / 8.0 if sigma_x is None else sigma_x
    sigma_y = L / 8.0 if sigma_y is None else sigma_y
    X, Y = grid.mesh()

    def packet(A, x0, kx):
        gauss = A * np.exp(-((X - x0) ** 2 / (2 * sigma_x ** 2)
                             + Y ** 2 / (2 * sigma_y ** 2)))
        return gauss * np.exp(1j * kx * (X - x0))

    return packet(amplitude1, x01, kx1) + packet(amplitude2, x02, kx2)


PHENOMENA = {
    "fundamental_soliton": fundamental_soliton,
    "multi_soliton": multi_soliton,
    "colliding_packets": colliding_packets,
    "akhmediev_breather": akhmediev_breather,
    "vortex": vortex,
    "vortex_lattice": vortex_lattice,
    "ring_soliton": ring_soliton,
    "multi_ring": multi_ring,
    "turbulent_condensate": turbulent_condensate,
}

# phenomena that take a system_type (the soliton profiles)
_TAKES_SYSTEM = {"fundamental_soliton", "multi_soliton"}


class NLSEPhenomenonSampler:
    """Reference-parity API over the registry (nlse_sampler.py:9-735)."""

    def __init__(self, nx, ny, L, seed=None):
        self.grid = Grid2D(nx, ny, L)
        self.rng = np.random.default_rng(seed)

    def generate_sample(self, phenomenon_type, system_type="cubic",
                        **params):
        fn = PHENOMENA[phenomenon_type]
        if phenomenon_type in _TAKES_SYSTEM:
            return fn(self.grid, self.rng, system_type=system_type, **params)
        return fn(self.grid, self.rng, **params)

    def generate_ensemble(self, phenomenon_type, system_type="cubic",
                          n_samples=10, parameter_ranges=None, **fixed):
        def draw():
            params = resolve_param_ranges(self.rng, parameter_ranges, fixed)
            return self.generate_sample(phenomenon_type, system_type,
                                        **params)
        return common.ensemble(draw, n_samples)

    def generate_diverse_ensemble(self, phenomenon_type, system_type="cubic",
                                  n_samples=10, parameter_ranges=None,
                                  similarity_threshold=0.2, max_attempts=100,
                                  diversity_metric="l2", **fixed):
        def draw():
            params = resolve_param_ranges(self.rng, parameter_ranges, fixed)
            return self.generate_sample(phenomenon_type, system_type,
                                        **params)

        def normalize(sample):
            m = np.max(np.abs(sample))
            return sample / m if m > 0 else sample

        return common.diverse_ensemble(
            draw, n_samples, similarity_threshold=similarity_threshold,
            max_attempts=max_attempts, diversity_metric=diversity_metric,
            normalize=normalize)
