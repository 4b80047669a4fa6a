"""2D real-wave (Klein-Gordon family) initial-condition phenomena.

Capability parity with finalized_scripts/real_sampler.py:5-1640 (RealWave-
Sampler): every phenomenon produces (u0, v0) on a Grid2D. Redesigned around
per-system kink/breather *primitives* shared by all composite phenomena —
the reference repeats each closed form inline per phenomenon per system.

All phenomena take (grid, rng, ...) and are registered in PHENOMENA; the
RealWaveSampler class at the bottom keeps the reference's class API.
"""

import numpy as np

from nlsolvers_tpu_torch.pipeline.grids import (Grid2D, gaussian_random_field,
                                          rotate2d, sech)
from nlsolvers_tpu_torch.pipeline.samplers import common

__all__ = ["PHENOMENA", "RealWaveSampler", "kink_primitive",
           "breather_primitive"]

SYSTEM_TYPES = ("sine_gordon", "double_sine_gordon", "hyperbolic_sine_gordon",
                "phi4", "klein_gordon")

_DSG_LAMBDA = 0.3   # double sine-Gordon coupling used throughout the sampler
                    # (real_sampler.py:37,161)


def _norm_system(s):
    return s.replace("-", "_")


# --------------------------------------------------------------------------
# Closed-form primitives
# --------------------------------------------------------------------------

def kink_primitive(system_type, xi, width, amplitude=1.0):
    """(u, s) for a kink with argument xi: u the profile and s the slope
    factor such that v = velocity * s for 'fitting' velocities.

    Forms per system: real_sampler.py:116-213.
    """
    system_type = _norm_system(system_type)
    if system_type == "sine_gordon":
        u = 4 * np.arctan(np.exp(xi / width))
        s = 4 / (width * np.cosh(xi / width) ** 2)
    elif system_type in ("phi4", "klein_gordon"):
        u = amplitude * np.tanh(xi / width)
        s = amplitude / (width * np.cosh(xi / width) ** 2)
    elif system_type == "double_sine_gordon":
        lam = _DSG_LAMBDA
        pref = np.sqrt((1 + lam) / lam)
        arg = np.sqrt(lam) * xi / (2 * width)
        u = 4 * np.arctan(pref * np.tanh(arg))
        s = 4 * pref * np.sqrt(lam) / (2 * width) * (1 - np.tanh(arg) ** 2)
    elif system_type == "hyperbolic_sine_gordon":
        u = 4 * np.arctan(np.exp(xi / width)) - 2 * np.pi
        s = 4 / (width * np.cosh(xi / width) ** 2)
    else:
        u = 4 * np.arctan(np.exp(xi / width))
        s = 4 / (width * np.cosh(xi / width) ** 2)
    return u, s


def breather_primitive(system_type, xi, amplitude, phase=0.0, frequency=0.9,
                       time_param=0.0):
    """(u, v_fit) for a breather with scaled argument xi
    (real_sampler.py:828-939). sine-Gordon-family amplitude is clamped
    below 1 (omega = sqrt(1 - a^2) must be real)."""
    system_type = _norm_system(system_type)
    if system_type in ("sine_gordon", "double_sine_gordon"):
        a = min(amplitude, 0.999)
        omega = np.sqrt(1 - a ** 2)
        snt = np.sin(omega * time_param + phase)
        cnt = np.cos(omega * time_param + phase)
        ch = np.cosh(a * xi)
        u = 4 * np.arctan(a * snt / (omega * ch))
        v = 4 * a * omega * cnt / (
            omega * ch * (1 + (a ** 2 / omega ** 2) * snt ** 2))
    elif system_type == "phi4":
        eps = amplitude
        u = amplitude * np.sqrt(2) * np.tanh(xi) / np.cosh(eps * time_param)
        v = (amplitude * np.sqrt(2) * eps * np.tanh(xi)
             * np.sinh(eps * time_param) / np.cosh(eps * time_param) ** 2)
    else:   # hyperbolic SG / KG: Gaussian oscillon
        u = amplitude * np.exp(-xi ** 2 / 2) * np.cos(
            frequency * time_param + phase)
        v = -amplitude * frequency * np.exp(-xi ** 2 / 2) * np.sin(
            frequency * time_param + phase)
    return u, v


def _resolve_velocity(grid, rng, u, v_fit, velocity_type, width=1.0):
    """'fitting' keeps the analytic v, 'zero' zeroes it, 'grf' replaces it
    with a random field scaled to 20% of max|u| (real_sampler.py:215-219)."""
    if velocity_type == "fitting":
        return v_fit
    if velocity_type == "grf":
        return gaussian_random_field(
            grid, rng, length_scale=width * 2.0,
            amplitude=np.max(np.abs(u)) * 0.2)
    return np.zeros_like(u)


# --------------------------------------------------------------------------
# Phenomena
# --------------------------------------------------------------------------

def kink_solution(grid, rng, system_type="sine_gordon", width=1.0,
                  position=(0.0, 0.0), orientation=0.0,
                  velocity=(0.0, 0.0), kink_type="standard",
                  velocity_type="fitting"):
    X, Y = grid.mesh()
    Xr, _ = rotate2d(X, Y, *position, angle=orientation)
    vx = velocity[0]
    if kink_type == "double":
        u1, s1 = kink_primitive(system_type, Xr, width)
        shift = {"phi4": 4, "klein_gordon": 4}.get(
            _norm_system(system_type), 2)
        u2, s2 = kink_primitive(system_type, Xr - shift * width, width)
        sign2 = -1 if _norm_system(system_type) in ("phi4",
                                                    "klein_gordon") else 1
        u, v = u1 + sign2 * u2, vx * (s1 + sign2 * s2)
    else:
        u, s = kink_primitive(system_type, Xr, width)
        if kink_type == "anti":
            # hyperbolic SG's antikink mirrors about +2pi, not 0
            # (real_sampler.py:181-186)
            if _norm_system(system_type) == "hyperbolic_sine_gordon":
                u = -(u + 2 * np.pi) + 2 * np.pi
            else:
                u = -u
            v = -vx * s
        else:
            v = vx * s
    return u, _resolve_velocity(grid, rng, u, v, velocity_type, width)


def _axis_kinks(grid, rng, coord, winding, width_range, randomize):
    """Sum of |winding| same-sign kinks along one axis
    (real_sampler.py:228-264)."""
    u = np.zeros_like(coord)
    if winding == 0:
        return u
    width = rng.uniform(*width_range)
    sign = 1 if winding > 0 else -1
    for i in range(abs(winding)):
        if randomize:
            pos = grid.L * (2 * rng.random() - 1)
        else:
            pos = grid.L * (-0.8 + 1.6 * i / abs(winding))
        w = width * (0.8 + 0.4 * rng.random())
        u += sign * 4 * np.arctan(np.exp((coord - pos) / w))
    return u


def kink_field(grid, rng, system_type="sine_gordon", winding_x=1,
               winding_y=0, width_range=(0.5, 3.0),
               randomize_positions=True, velocity_type="grf"):
    X, Y = grid.mesh()
    u = (_axis_kinks(grid, rng, X, winding_x, width_range,
                     randomize_positions)
         + _axis_kinks(grid, rng, Y, winding_y, width_range,
                       randomize_positions))
    v = _resolve_velocity(grid, rng, u, np.zeros_like(u),
                          "grf" if velocity_type != "zero" else "zero",
                          width=float(np.mean(width_range)) / 2)
    if velocity_type == "grf":
        v = gaussian_random_field(grid, rng,
                                  length_scale=np.mean(width_range) * 2.0,
                                  amplitude=np.max(np.abs(u)) * 0.1)
    return u, v


def kink_array_field(grid, rng, system_type="sine_gordon", num_kinks_x=1,
                     num_kinks_y=1, width_range=(0.5, 2.0), jitter=0.3):
    """Evenly spaced jittered kinks with random signs, zero velocity
    (real_sampler.py:273-305)."""
    X, Y = grid.mesh()
    u = np.zeros_like(X)
    for coord, count in ((X, num_kinks_x), (Y, num_kinks_y)):
        if count <= 0:
            continue
        width = rng.uniform(*width_range)
        spacing = 2.0 * grid.L / (count + 1)
        for i in range(count):
            pos = -grid.L + (i + 1) * spacing
            if jitter > 0:
                pos += jitter * spacing * (2 * rng.random() - 1)
            sign = 1 if rng.random() > 0.5 else -1
            w = width * (0.8 + 0.4 * rng.random())
            u += sign * 4 * np.arctan(np.exp((coord - pos) / w))
    return u, np.zeros_like(u)


def breather_solution(grid, rng, system_type="sine_gordon", amplitude=0.5,
                      frequency=0.9, width=1.0, position=(0.0, 0.0),
                      phase=0.0, orientation=0.0, breather_type="standard",
                      time_param=0.0, velocity_type="fitting"):
    X, Y = grid.mesh()
    Xr, Yr = rotate2d(X, Y, *position, angle=orientation)
    if breather_type == "radial":
        xi = np.sqrt(Xr ** 2 + Yr ** 2) / width
    else:
        xi = Xr / width
    u, v = breather_primitive(system_type, xi, amplitude, phase, frequency,
                              time_param)
    return u, _resolve_velocity(grid, rng, u, v, velocity_type, width)


def breather_field(grid, rng, system_type="sine_gordon", num_breathers=1,
                   position_type="random", time_param=0.0):
    """Random-direction sine-Gordon breathers summed over positions
    (real_sampler.py:949-1013)."""
    X, Y = grid.mesh()
    positions = _positions_2d(grid, rng, num_breathers, position_type)
    u = np.zeros_like(X)
    v = np.zeros_like(X)
    for x0, y0 in positions:
        width = 0.5 + 2.5 * rng.random()
        amp = 0.1 + 0.8 * rng.random()
        phase = 2 * np.pi * rng.random()
        pick = rng.random()
        if pick < 0.33:
            xi = (X - x0) / width
        elif pick < 0.66:
            xi = (Y - y0) / width
        else:
            xi = np.sqrt((X - x0) ** 2 + (Y - y0) ** 2) / width
        uc, vc = breather_primitive("sine_gordon", xi, amp, phase,
                                    time_param=time_param)
        u += uc
        v += vc
    return u, v


def _positions_2d(grid, rng, n, position_type):
    """random / circle / line placement (real_sampler.py:316-336)."""
    if position_type == "circle":
        radius = 0.6 * grid.L * rng.random()
        return [(radius * np.cos(2 * np.pi * i / n),
                 radius * np.sin(2 * np.pi * i / n)) for i in range(n)]
    if position_type == "line":
        out = []
        for i in range(n):
            pos = -grid.L + 2 * grid.L * i / (n - 1 if n > 1 else 1)
            out.append((pos, 0.0) if rng.random() > 0.5 else (0.0, pos))
        return out
    return [(grid.L * (2 * rng.random() - 1),
             grid.L * (2 * rng.random() - 1)) for _ in range(n)]


def multi_breather_field(grid, rng, system_type="sine_gordon",
                         num_breathers=3, position_type="random",
                         amplitude_range=(0.2, 0.8), width_range=(0.5, 2.0),
                         frequency_range=(0.6, 0.95), time_param=0.0,
                         velocity_type="fitting"):
    u = v = 0.0
    for x0, y0 in _positions_2d(grid, rng, num_breathers, position_type):
        uc, vc = breather_solution(
            grid, rng, system_type,
            amplitude=rng.uniform(*amplitude_range),
            frequency=rng.uniform(*frequency_range),
            width=rng.uniform(*width_range), position=(x0, y0),
            phase=2 * np.pi * rng.random(),
            orientation=2 * np.pi * rng.random(),
            breather_type="standard" if rng.random() > 0.5 else "radial",
            time_param=time_param, velocity_type=velocity_type)
        u = u + uc
        v = v + vc
    return u, v


def spiral_wave_field(grid, rng, num_arms=2, decay_rate=0.5, amplitude=1.0,
                      position=None, phase=0.0, k_factor=None):
    """Archimedean spiral pattern with exponential decay
    (real_sampler.py:368-394)."""
    if position is None:
        position = (grid.L * (2 * rng.random() - 1),
                    grid.L * (2 * rng.random() - 1))
    k = k_factor if k_factor is not None else 1.0 + 2.0 * rng.random()
    r, theta = grid.polar(*position)
    u = amplitude * np.cos(num_arms * (theta + k * r / grid.L + phase)) \
        * np.exp(-decay_rate * r / grid.L)
    v = amplitude * 0.1 * gaussian_random_field(grid, rng,
                                                length_scale=grid.L / 5)
    return u, v


def multi_spiral_state(grid, rng, n_spirals=3, amplitude_range=(0.5, 1.5),
                       num_arms_range=(1, 4), decay_rate_range=(0.3, 0.7),
                       position_variance=1.0, interaction_strength=0.7):
    u = v = None
    for i in range(n_spirals):
        uc, vc = spiral_wave_field(
            grid, rng,
            num_arms=int(rng.integers(num_arms_range[0],
                                      num_arms_range[1] + 1)),
            decay_rate=rng.uniform(*decay_rate_range),
            amplitude=rng.uniform(*amplitude_range),
            position=tuple(rng.normal(0.0, position_variance * grid.L / 4,
                                      2)),
            phase=2 * np.pi * rng.random(),
            k_factor=1.0 + 2.0 * rng.random())
        if u is None:
            u, v = uc, vc
        else:
            u = u + interaction_strength * uc
            v = v + interaction_strength * vc
    return u, v


def ring_soliton(grid, rng, system_type="sine_gordon", amplitude=1.0,
                 radius=2.0, width=0.5, position=(0.0, 0.0), velocity=0.0,
                 ring_type="expanding", modulation_strength=0.0,
                 modulation_mode=2, time_param=0.0):
    """Radial kink ring; 'kink_antikink' is a shell pair at radius +- width
    (real_sampler.py:435-542)."""
    r, theta = grid.polar(*position)
    if ring_type == "kink_antikink":
        w2 = width / 2
        u_in, s_in = kink_primitive(system_type, radius - width - r, w2,
                                    amplitude)
        u_out, s_out = kink_primitive(system_type, radius + width - r, w2,
                                      amplitude)
        if _norm_system(system_type) == "hyperbolic_sine_gordon":
            # shells cancel the two -2pi offsets; reference keeps one
            u = (u_in + 2 * np.pi) - (u_out + 2 * np.pi) - 2 * np.pi
        else:
            u = u_in - u_out
        v = -velocity * s_in + velocity * s_out
    else:
        u, s = kink_primitive(system_type, radius - r, width, amplitude)
        v = -velocity * s
    if modulation_strength > 0:
        mod = 1 + modulation_strength * np.cos(modulation_mode * theta)
        u, v = u * mod, v * mod
    return u, v


def colliding_rings(grid, rng, system_type="sine_gordon", num_rings=2,
                    ring_type="random", amplitude=1.0):
    """Rings with Gaussian velocity shells, random/concentric/nested
    (real_sampler.py:544-591)."""
    X, Y = grid.mesh()
    u = np.zeros_like(X)
    v = np.zeros_like(X)

    def add_ring(x0, y0, r0, width, direction, sign):
        r = np.sqrt((X - x0) ** 2 + (Y - y0) ** 2)
        nonlocal u, v
        u = u + sign * 4 * np.arctan(np.exp((r - r0) / width))
        v = v + sign * direction * np.exp(-(r - r0) ** 2 / (2 * width ** 2))

    if ring_type == "concentric":
        x0 = grid.L * (2 * rng.random() - 1)
        y0 = grid.L * (2 * rng.random() - 1)
        for i in range(num_rings):
            add_ring(x0, y0, (0.2 + 0.6 * i / num_rings) * grid.L,
                     0.5 + 1.5 * rng.random(), 1.0, 1 if i % 2 == 0 else -1)
    elif ring_type == "nested":
        for i in range(num_rings):
            off = 0.3 * grid.L * i / num_rings
            add_ring(off * (2 * rng.random() - 1),
                     off * (2 * rng.random() - 1),
                     (0.2 + 0.5 * (num_rings - i) / num_rings) * grid.L,
                     0.5 + 1.5 * rng.random(), 1.0, 1 if i % 2 == 0 else -1)
    else:
        for _ in range(num_rings):
            add_ring(grid.L * (2 * rng.random() - 1),
                     grid.L * (2 * rng.random() - 1),
                     0.1 * grid.L + 0.6 * grid.L * rng.random(),
                     0.5 + 2.5 * rng.random(),
                     1 if rng.random() > 0.5 else -1,
                     1 if rng.random() > 0.5 else -1)
    return u, v


def multi_ring_state(grid, rng, system_type="sine_gordon", n_rings=3,
                     radius_range=(1.0, 5.0), width_range=(0.3, 0.8),
                     position_variance=0.5, arrangement="concentric",
                     separation=2.0, interaction_strength=0.7,
                     modulation_strength=0.2, modulation_mode_range=(1, 4)):
    positions = common.arrange_positions(
        rng, n_rings, arrangement, grid.L, separation=separation,
        position_variance=position_variance)
    u = v = None
    for i, (x0, y0) in enumerate(positions):
        if arrangement == "concentric" and n_rings > 1:
            radius = radius_range[0] + (radius_range[1] - radius_range[0]) \
                * i / (n_rings - 1)
        else:
            radius = rng.uniform(*radius_range)
        mod_mode = (int(rng.integers(modulation_mode_range[0],
                                     modulation_mode_range[1] + 1))
                    if modulation_strength > 0 else 0)
        uc, vc = ring_soliton(
            grid, rng, system_type, amplitude=1.0, radius=radius,
            width=rng.uniform(*width_range), position=(x0, y0),
            velocity=rng.uniform(-0.2, 0.2),
            ring_type="expanding" if rng.random() > 0.5 else "kink_antikink",
            modulation_strength=modulation_strength,
            modulation_mode=mod_mode)
        if u is None:
            u, v = uc, vc
        else:
            u = u + interaction_strength * uc
            v = v + interaction_strength * vc
    return u, v


def skyrmion_solution(grid, rng, system_type="sine_gordon", amplitude=1.0,
                      radius=1.0, position=(0.0, 0.0), charge=1,
                      profile="standard"):
    """u/v = in-plane spin components of a hedgehog map
    (real_sampler.py:660-679)."""
    r, theta = grid.polar(*position)
    if profile == "compact":
        phi = np.pi * (1 - np.exp(-(r / radius) ** 2))
    elif profile == "exponential":
        phi = np.pi * (1 - np.exp(-r / radius))
    else:
        phi = 2 * np.arctan(r / radius)
    return (amplitude * np.sin(phi) * np.cos(charge * theta),
            amplitude * np.sin(phi) * np.sin(charge * theta))


def skyrmion_lattice(grid, rng, system_type="sine_gordon", n_skyrmions=5,
                     radius_range=(0.5, 1.5), amplitude=1.0,
                     arrangement="triangular", separation=3.0,
                     charge_distribution="alternating"):
    if arrangement in ("triangular", "square"):
        positions = common.arrange_positions(rng, n_skyrmions, arrangement,
                                             grid.L, separation=separation)
    else:
        positions = np.column_stack([
            rng.uniform(-grid.L, grid.L, n_skyrmions),
            rng.uniform(-grid.L, grid.L, n_skyrmions)])
    if charge_distribution == "alternating":
        charges = [(-1) ** i for i in range(n_skyrmions)]
    elif charge_distribution == "same":
        charges = [1] * n_skyrmions
    else:
        charges = [1 if rng.random() > 0.5 else -1
                   for _ in range(n_skyrmions)]
    u = v = 0.0
    for (x0, y0), q in zip(positions, charges):
        uc, vc = skyrmion_solution(
            grid, rng, system_type, amplitude,
            radius=rng.uniform(*radius_range), position=(x0, y0), charge=q,
            profile=["standard", "compact",
                     "exponential"][rng.integers(3)])
        u = u + uc
        v = v + vc
    return u, v


def skyrmion_like_field(grid, rng, num_skyrmions=1):
    """Rational-map construction with quartic cutoff
    (real_sampler.py:742-768)."""
    X, Y = grid.mesh()
    phi = np.zeros_like(X)
    for _ in range(num_skyrmions):
        x0, y0 = grid.L * (2 * rng.random(2) - 1)
        lam = 0.2 * grid.L + 0.4 * grid.L * rng.random()
        q = rng.choice([-1, 1])
        alpha = 2 * np.pi * rng.random()
        z = (X - x0) + 1j * (Y - y0)
        w = (z if q > 0 else z.conjugate()) / (lam + np.abs(z))
        angle = np.angle(w * np.exp(1j * alpha))
        r = np.abs(z)
        profile = 2 * np.arctan2(lam, r)
        phi += np.exp(-(r / (0.8 * grid.L)) ** 4) \
            * 2 * profile * angle / np.pi
    return phi, 0.05 * gaussian_random_field(grid, rng,
                                             length_scale=grid.L)


def q_ball_solution(grid, rng, system_type="sine_gordon", amplitude=1.0,
                    radius=1.0, position=(0.0, 0.0), phase=0.0,
                    frequency=0.8, charge=1, time_param=0.0):
    """sech-profile rotor: u = P cos(theta), v = -P omega sin(theta)
    (real_sampler.py:770-781)."""
    r, _ = grid.polar(*position)
    omega = frequency * np.sign(charge)
    profile = amplitude * sech(r / (radius / np.sqrt(2)))
    t = omega * time_param + phase
    return profile * np.cos(t), -profile * omega * np.sin(t)


def multi_q_ball(grid, rng, system_type="sine_gordon", n_qballs=3,
                 amplitude_range=(0.2, 1.0), radius_range=(0.5, 2.0),
                 frequency_range=(0.4, 0.9), position_variance=0.3,
                 interaction_strength=1.0, time_param=0.0):
    u = v = None
    for i in range(n_qballs):
        uc, vc = q_ball_solution(
            grid, rng, system_type,
            amplitude=rng.uniform(*amplitude_range),
            radius=rng.uniform(*radius_range),
            position=tuple(rng.normal(0.0, position_variance * grid.L / 4,
                                      2)),
            phase=2 * np.pi * rng.random(),
            frequency=rng.uniform(*frequency_range),
            charge=1 if rng.random() > 0.5 else -1,
            time_param=time_param)
        if u is None:
            u, v = uc, vc
        else:
            u = u + interaction_strength * uc
            v = v + interaction_strength * vc
    return u, v


def soliton_antisoliton_pair(grid, rng, system_type="sine_gordon",
                             pattern_type="auto"):
    """Kink/antikink pairs in radial/linear/angular/nested patterns with a
    GRF velocity (real_sampler.py:1058-1092)."""
    X, Y = grid.mesh()
    if pattern_type == "auto":
        pattern_type = rng.choice(["radial", "linear", "angular", "nested"])
    width = 0.8 + 2.2 * rng.random()
    x0, y0 = grid.L * (2 * rng.random(2) - 1)
    if pattern_type == "radial":
        r = np.sqrt((X - x0) ** 2 + (Y - y0) ** 2)
        u = 4 * np.arctan(np.exp(r / width)) \
            - 4 * np.arctan(np.exp((r - 0.5 * width) / width))
    elif pattern_type == "linear":
        theta = np.pi * rng.random()
        xr = (X - x0) * np.cos(theta) + (Y - y0) * np.sin(theta)
        u = 4 * np.arctan(np.exp(xr / width)) \
            - 4 * np.arctan(np.exp(-xr / width))
    elif pattern_type == "angular":
        phi = np.arctan2(Y - y0, X - x0)
        u = 4 * np.arctan(np.exp(np.sin(phi) / width)) \
            - 4 * np.arctan(np.exp(-np.sin(phi) / width))
    else:
        r1 = 0.3 * grid.L + 0.1 * grid.L * rng.random()
        r2 = 0.6 * grid.L + 0.1 * grid.L * rng.random()
        r = np.sqrt((X - x0) ** 2 + (Y - y0) ** 2)
        u = 4 * np.arctan(np.exp((r - r1) / width)) \
            - 4 * np.arctan(np.exp((r - r2) / width))
    v = 0.2 * gaussian_random_field(grid, rng, length_scale=width,
                                    anisotropy_ratio=2.0)
    return u, v


def elliptical_soliton(grid, rng, system_type="sine_gordon",
                       complexity="simple"):
    """Breathers on elliptical level sets; 'complex' superposes several
    (real_sampler.py:1094-1150)."""
    X, Y = grid.mesh()

    def one():
        x0, y0 = (grid.L / 2) * (2 * rng.random(2) - 1)
        a = 0.1 * grid.L + 0.2 * grid.L * rng.random()
        b = a * (0.2 + 0.8 * rng.random())
        Xr, Yr = rotate2d(X, Y, x0, y0, np.pi * rng.random())
        r_ell = np.sqrt((Xr / a) ** 2 + (Yr / b) ** 2)
        amp = (0.3 if complexity != "complex"
               else 0.2 + 0.3 * rng.random())
        return breather_primitive("sine_gordon", r_ell, amp,
                                  phase=2 * np.pi * rng.random())

    if complexity == "complex":
        u = v = 0.0
        for _ in range(int(rng.integers(2, 5))):
            uc, vc = one()
            u, v = u + uc, v + vc
        return u, v
    return one()


def wavelet_superposition(grid, rng, n_wavelets=20, scale_range=(0.1, 2.0),
                          kappa=0.5, freq_range=(0.5, 3.0), amplitude=1.0):
    """Random cosine / Mexican-hat / Gabor wavelet sum, max-normalized
    (real_sampler.py:67-101). Useful as velocity fields."""
    X, Y = grid.mesh()
    v = np.zeros_like(X)
    for _ in range(n_wavelets):
        scale = rng.uniform(*scale_range)
        theta = 2 * np.pi * rng.random()
        x0 = grid.L * (rng.random() - 0.5)
        y0 = grid.L * (rng.random() - 0.5)
        k0 = rng.uniform(*freq_range) * 2 * np.pi / (scale * grid.L)
        envelope = np.exp(-((X - x0) ** 2 + (Y - y0) ** 2)
                          / (2 * (scale * grid.L) ** 2))
        z = (X - x0) * np.cos(theta) + (Y - y0) * np.sin(theta)
        pick = rng.random()
        if pick < 0.33:
            carrier = np.cos(k0 * z)
        elif pick < 0.66:
            zs = z / (scale * grid.L)
            carrier = -zs * np.exp(-zs ** 2 / 2)
        else:
            carrier = np.cos(k0 * z) * np.exp(-(z / (scale * grid.L)) ** 2
                                              / 2)
        v += ((1 - kappa) + kappa * rng.random()) * envelope * carrier
    return v / np.max(np.abs(v)) * amplitude


def grf_modulated_soliton_field(grid, rng, system_type="sine_gordon",
                                grf_length_scale=1.0, smoothness_scaling=2.0,
                                anisotropy_ratio=1.0, anisotropy_angle=0.0,
                                construction_method="threshold",
                                mixture_type="additive",
                                velocity_mode="fitting",
                                threshold_values=None, soliton_types=None,
                                level_set_width=0.2, continuous_range=None,
                                random_velocity_scale=0.2):
    """Solitons painted onto GRF level sets (real_sampler.py:1152-1432):
    'threshold' assigns a soliton type per GRF band, 'level_set' blends
    Gaussian-weighted layers, 'continuous' warps one soliton by the GRF.
    """
    X, Y = grid.mesh()
    g = smoothness_scaling * gaussian_random_field(
        grid, rng, length_scale=grf_length_scale,
        anisotropy_ratio=anisotropy_ratio, theta=anisotropy_angle,
        amplitude=1.0)

    def soliton_on(arg, soliton_type):
        """(u, v_fit) for a soliton profile evaluated on array `arg`."""
        if soliton_type in ("kink", "antikink"):
            width = 0.5 + 1.0 * rng.random()
            sign = -1 if soliton_type == "antikink" else 1
            u = sign * 4 * np.arctan(np.exp(arg / width))
            v = sign * 4 / (width * np.cosh(arg / width) ** 2)
        elif soliton_type == "breather":
            width = 0.5 + 1.0 * rng.random()
            amp = 0.2 + 0.7 * rng.random()
            u, v = breather_primitive("sine_gordon", arg / width, amp,
                                      phase=2 * np.pi * rng.random())
        else:  # ring
            radius = 0.2 + 0.3 * rng.random()
            width = 0.3 + 0.5 * rng.random()
            rt = np.abs(arg) - radius
            u = 4 * np.arctan(np.exp(rt / width))
            v = -0.2 * rng.random() * 4 / (width * np.cosh(rt / width) ** 2)
        return u, v

    def with_velocity_mode(u, v, shape):
        if velocity_mode == "fitting":
            return v
        if velocity_mode == "random":
            return random_velocity_scale * (2 * rng.random(shape) - 1)
        return np.zeros(shape)

    if construction_method == "threshold":
        threshold_values = threshold_values or [-1.0, 0.0, 1.0]
        soliton_types = soliton_types or ["kink", "breather", "antikink"]
        u = np.zeros_like(X)
        v = np.zeros_like(X)
        for i in range(len(threshold_values) - 1):
            mask = (g >= threshold_values[i]) & (g < threshold_values[i + 1])
            su, sv = soliton_on(g[mask],
                                soliton_types[i % len(soliton_types)])
            u[mask] = su
            v[mask] = with_velocity_mode(su, sv, su.shape)
        return u, v

    if construction_method == "level_set":
        threshold_values = threshold_values or [-1.5, -0.5, 0.5, 1.5]
        soliton_types = soliton_types or ["kink", "breather", "antikink",
                                          "ring"]
        u = np.zeros_like(X)
        v = np.zeros_like(X)
        for i, thr in enumerate(threshold_values):
            st = soliton_types[i % len(soliton_types)]
            weight = np.exp(-(g - thr) ** 2 / (2 * level_set_width ** 2))
            if st in ("kink", "antikink"):
                orientation = np.pi * rng.random()
                arg = X * np.cos(orientation) + Y * np.sin(orientation)
            elif st == "breather":
                arg = np.sqrt(X ** 2 + Y ** 2)
            else:
                arg = np.sqrt(X ** 2 + Y ** 2) - (1.0 + rng.random())
            su, sv = soliton_on(arg, st)
            sv = with_velocity_mode(su, sv, X.shape)
            if mixture_type == "additive":
                u, v = u + weight * su, v + weight * sv
            elif mixture_type == "maximum":
                new_u = np.maximum(u, weight * su)
                v = np.where(new_u == weight * su, weight * sv, v)
                u = new_u
            else:  # blending
                if i == 0:
                    u, v = weight * su, weight * sv
                else:
                    u = u * (1 - weight) + weight * su
                    v = v * (1 - weight) + weight * sv
        return u, v

    # continuous
    continuous_range = continuous_range or {"amplitude": (0.2, 0.8),
                                            "width": (0.5, 2.0)}
    lo_w, hi_w = continuous_range.get("width", (0.5, 2.0))
    lo_a, hi_a = continuous_range.get("amplitude", (0.2, 0.8))
    norm = (g - g.min()) / (g.max() - g.min())
    width = lo_w + (hi_w - lo_w) * norm
    amplitude = lo_a + (hi_a - lo_a) * norm
    u, s = kink_primitive(system_type, g, width, amplitude)
    v = with_velocity_mode(u, s, X.shape)
    return u, v


PHENOMENA = {
    "kink_solution": kink_solution,
    "kink_field": kink_field,
    "kink_array_field": kink_array_field,
    "breather_solution": breather_solution,
    "breather_field": breather_field,
    "multi_breather_field": multi_breather_field,
    "spiral_wave_field": spiral_wave_field,
    "multi_spiral_state": multi_spiral_state,
    "ring_soliton": ring_soliton,
    "colliding_rings": colliding_rings,
    "multi_ring_state": multi_ring_state,
    "skyrmion_solution": skyrmion_solution,
    "skyrmion_lattice": skyrmion_lattice,
    "skyrmion_like_field": skyrmion_like_field,
    "q_ball_solution": q_ball_solution,
    "multi_q_ball": multi_q_ball,
    "soliton_antisoliton_pair": soliton_antisoliton_pair,
    "elliptical_soliton": elliptical_soliton,
    "grf_modulated_soliton_field": grf_modulated_soliton_field,
}

# phenomena whose signature has no system_type
_NO_SYSTEM = {"spiral_wave_field", "multi_spiral_state",
              "skyrmion_like_field"}
# phenomena that accept a velocity_type kwarg (real_sampler.py:1437-1452)
_TAKES_VELOCITY = {"kink_solution", "kink_field", "breather_solution",
                   "multi_breather_field"}


class RealWaveSampler:
    """Reference-parity API over the registry (real_sampler.py:10-1623)."""

    def __init__(self, nx, ny, L, seed=None):
        self.grid = Grid2D(nx, ny, L)
        self.rng = np.random.default_rng(seed)

    def generate_sample(self, system_type="sine_gordon",
                        phenomenon_type="kink_solution", **params):
        fn = PHENOMENA[phenomenon_type]
        if phenomenon_type in _NO_SYSTEM:
            params.pop("velocity_type", None)
            return fn(self.grid, self.rng, **params)
        return fn(self.grid, self.rng, system_type=system_type, **params)

    def generate_ensemble(self, system_type="sine_gordon",
                          phenomenon_type="kink_solution", n_samples=10,
                          parameter_ranges=None, **fixed):
        from nlsolvers_tpu_torch.pipeline.grids import resolve_param_ranges

        def draw():
            params = resolve_param_ranges(self.rng, parameter_ranges, fixed)
            return self.generate_sample(system_type, phenomenon_type,
                                        **params)
        return common.ensemble(draw, n_samples)

    def generate_diverse_ensemble(self, system_type="sine_gordon",
                                  phenomenon_type="kink_solution",
                                  n_samples=10, parameter_ranges=None,
                                  similarity_threshold=0.2, max_attempts=100,
                                  diversity_metric="l2", **fixed):
        from nlsolvers_tpu_torch.pipeline.grids import resolve_param_ranges

        def draw():
            params = resolve_param_ranges(self.rng, parameter_ranges, fixed)
            return self.generate_sample(system_type, phenomenon_type,
                                        **params)
        return common.diverse_ensemble(
            draw, n_samples, similarity_threshold=similarity_threshold,
            max_attempts=max_attempts, diversity_metric=diversity_metric)

    def generate_initial_condition(self, system_type="sine_gordon",
                                   phenomenon_type=None,
                                   velocity_type="fitting", **params):
        if phenomenon_type is None:
            raise ValueError("phenomenon_type is required")
        if phenomenon_type in _TAKES_VELOCITY:
            params.setdefault("velocity_type", velocity_type)
        return self.generate_sample(system_type, phenomenon_type, **params)
