"""Coefficient-field generators: anisotropy c(x) and nonlinearity mass m(x).

Capability parity with finalized_scripts/{c,m}_fields_{2d,3d}.py, redesigned:
one dimension-generic implementation per field type (the reference duplicates
every generator for 2D and 3D), registry dispatch instead of if/elif chains,
and an explicit `np.random.Generator` instead of the global numpy RNG.

c-field types (c_fields_2d.py:169-248): constant, periodic, piecewise_layers,
sign_changing, layered, waveguide, quasiperiodic, turbulent.
m-field types (m_fields_2d.py:147-238): constant, piecewise, gradient, phase,
topological, defects, quasiperiodic, multiscale (gradient/phase/topological
derive m from a given c field).
"""

import numpy as np
from scipy.ndimage import gaussian_filter, laplace

from nlsolvers_tpu_torch.pipeline.grids import Grid2D, Grid3D

__all__ = ["c_field", "m_field", "sample_c_field", "sample_m_field",
           "C_FIELD_TYPES", "M_FIELD_TYPES"]


def _coords(grid):
    return grid.mesh()


# --------------------------------------------------------------------------
# c(x) — anisotropy / wave-speed fields
# --------------------------------------------------------------------------

def c_constant(grid, rng, base_value=1.0):
    return np.full(np.shape(grid.mesh()[0]), base_value, np.float64)


def c_periodic(grid, rng, base_value=1.0, amplitude=0.5, frequency=3):
    """base * (1 + a * prod_d sin(pi f x_d / L)) (c_fields_2d.py:15-19)."""
    k = np.pi * frequency / grid.L
    prod = np.prod([np.sin(k * X) for X in _coords(grid)], axis=0)
    return base_value * (1 + amplitude * prod)


def c_piecewise_layers(grid, rng, base_value=1.0, num_layers=3,
                       contrast_factor=2.0):
    """Alternating x-slabs at base/contrast (c_fields_2d.py:21-33)."""
    X = _coords(grid)[0]
    layer = np.floor((X + grid.L) / (2 * grid.L / num_layers)).astype(int)
    return np.where(layer % 2 == 1, base_value * contrast_factor,
                    base_value).astype(np.float64)


def c_sign_changing(grid, rng, base_value=1.0, regions="checkerboard",
                    scale=2, sharpness=5.0):
    """tanh-sharpened checkerboard / half-space sign pattern
    (c_fields_2d.py:36-51) — exercises sign-indefinite operators."""
    coords = _coords(grid)
    if regions == "checkerboard":
        cell = grid.L / scale
        pattern = np.prod([np.sin(np.pi * X / cell) for X in coords[:2]],
                          axis=0)
    elif regions == "half_space":
        pattern = coords[0] / grid.L
    else:
        raise ValueError(f"unknown region pattern {regions!r}")
    if sharpness > 0:
        return base_value * np.tanh(sharpness * pattern)
    return base_value * np.sign(pattern)


def _minmax_normalize(p, base_value):
    lo, hi = np.min(p), np.max(p)
    return base_value * (p - lo) / (hi - lo)


def c_layered(grid, rng, base_value=1.0, num_layers=3, min_amplitude=0.2,
              max_amplitude=0.8, min_freq=2, max_freq=10):
    """Superposed randomly oriented plane-wave layers, minmax-normalized
    (c_fields_2d.py:53-73)."""
    coords = _coords(grid)
    profile = np.ones_like(coords[0]) * base_value
    for _ in range(num_layers):
        direction = rng.standard_normal(len(coords))
        direction /= np.linalg.norm(direction)
        proj = sum(d * X for d, X in zip(direction, coords))
        amp = rng.uniform(min_amplitude, max_amplitude)
        freq = rng.uniform(min_freq, max_freq)
        phase = rng.uniform(0, 2 * np.pi)
        profile = profile + amp * np.sin(freq * proj + phase)
    return _minmax_normalize(profile, base_value)


def c_waveguide(grid, rng, base_value=1.0, num_guides=None, min_width=0.1,
                max_width=0.5, guide_amplitude=0.8, n_curve_points=100):
    """Gaussian-profile guides along random lines/ellipses; profile is the
    pointwise max of base and all guides (c_fields_2d.py:75-117)."""
    coords = _coords(grid)
    d = len(coords)
    if num_guides is None:
        num_guides = int(rng.integers(3, 12))
    profile = np.ones_like(coords[0]) * base_value
    pts = np.stack([X.ravel() for X in coords], axis=1)
    for _ in range(num_guides):
        width = rng.uniform(min_width, max_width)
        if rng.random() < 0.5:   # straight line
            origin = rng.uniform(-grid.L, grid.L, d)
            direction = rng.standard_normal(d)
            direction /= np.linalg.norm(direction)
            t = np.linspace(-1.5 * grid.L, 1.5 * grid.L, n_curve_points)
            curve = origin[None] + t[:, None] * direction[None]
        else:                    # ellipse in the first two dims
            a, b = rng.uniform(0.5, 2.0, 2)
            phi = rng.uniform(0, 2 * np.pi)
            t = np.linspace(0, 2 * np.pi, n_curve_points)
            curve = np.zeros((n_curve_points, d))
            curve[:, 0] = a * np.cos(t + phi)
            curve[:, 1] = b * np.sin(t)
        # min distance from each grid point to the sampled curve, chunked to
        # bound the temporary to ~n_curve_points * chunk doubles
        dist = np.empty(pts.shape[0])
        chunk = max(1, 2_000_000 // n_curve_points)
        for s in range(0, pts.shape[0], chunk):
            diff = pts[s:s + chunk, None, :] - curve[None, :, :]
            dist[s:s + chunk] = np.sqrt((diff ** 2).sum(-1)).min(1)
        guide = guide_amplitude * np.exp(
            -dist.reshape(coords[0].shape) ** 2 / (2 * width ** 2))
        profile = np.maximum(profile, guide)
    return profile


def _golden_wavevectors(rng, n_waves, d):
    """Golden-ratio scaled wave set shared by the quasiperiodic c and m
    generators (c_fields_2d.py:119-133)."""
    golden = (1 + np.sqrt(5)) / 2
    ks = []
    for i in range(n_waves):
        angle = i * np.pi / n_waves
        k = np.zeros(d)
        k[0] = np.cos(angle)
        k[1 % d] = np.sin(angle) if d > 1 else k[1 % d]
        if d == 3:
            k[2] = np.sin(i * np.pi / (n_waves + 1))
        ks.append(k * golden ** i)
    return ks


def _quasi_periodic(grid, rng, base_value, num_waves, min_amp, max_amp):
    coords = _coords(grid)
    profile = np.ones_like(coords[0]) * base_value
    for k in _golden_wavevectors(rng, num_waves, len(coords)):
        amp = rng.uniform(min_amp, max_amp)
        phase = rng.uniform(0, 2 * np.pi)
        kx = sum(ki * X for ki, X in zip(k, coords))
        profile = profile + amp * np.cos(kx + phase)
    return profile


def c_quasiperiodic(grid, rng, base_value=1.0, num_waves=5, min_amp=0.1,
                    max_amp=0.5):
    return _minmax_normalize(
        _quasi_periodic(grid, rng, base_value, num_waves, min_amp, max_amp),
        base_value)


def c_turbulent(grid, rng, base_value=1.0, intensity=0.5, min_scale=2,
                max_scale=20, beta=5 / 3, num_octaves=5):
    """Octave-summed smoothed noise with power-law amplitudes, exponentially
    mapped around base (c_fields_2d.py:147-167)."""
    shape = _coords(grid)[0].shape
    field_ = np.zeros(shape)
    for octave in range(num_octaves):
        scale = max_scale / (2 ** octave)
        if scale < min_scale:
            break
        field_ += scale ** beta * gaussian_filter(
            rng.standard_normal(shape), scale)
    field_ -= field_.min()
    field_ /= field_.max()
    return base_value * np.exp(intensity * (field_ - 0.5))


C_FIELD_TYPES = {
    "constant": c_constant,
    "periodic": c_periodic,
    "piecewise_layers": c_piecewise_layers,
    "sign_changing": c_sign_changing,
    "layered": c_layered,
    "waveguide": c_waveguide,
    "quasiperiodic": c_quasiperiodic,
    "turbulent": c_turbulent,
}

# Reference CLI aliases (complex_launcher_2d.py --anisotropy-type choices).
_C_ALIASES = {"periodic_structure": "periodic",
              "piecewise_constant": "piecewise_layers",
              "sign_changing_mass": "sign_changing"}


# --------------------------------------------------------------------------
# m(x) — nonlinearity mass fields
# --------------------------------------------------------------------------

def m_constant(grid, rng, m0=1.0):
    return np.full(np.shape(grid.mesh()[0]), m0, np.float64)


def m_piecewise(grid, rng, m0=1.0, m2=None, boundary_type="circle",
                boundary_param=0.5, smooth_width=0.05):
    """Two-level mass with a tanh-smoothed interface (m_fields_2d.py:17-37);
    boundary ∈ {circle/sphere, square, horizontal, vertical, diagonal}."""
    coords = _coords(grid)
    if m2 is None:
        m2 = rng.uniform(1.5, 3.0) * m0
    if boundary_type in ("circle", "sphere"):
        r = np.sqrt(sum(X ** 2 for X in coords))
        b = r - boundary_param * grid.L
    elif boundary_type == "square":
        b = np.max([np.abs(X) for X in coords], axis=0) \
            - boundary_param * grid.L
    elif boundary_type == "horizontal":
        b = coords[1 % len(coords)]
    elif boundary_type == "vertical":
        b = coords[0]
    elif boundary_type == "diagonal":
        b = sum(coords)
    else:
        raise ValueError(f"unknown boundary {boundary_type!r}")
    return m0 + (m2 - m0) * 0.5 * (1 + np.tanh(b / (smooth_width * grid.L)))


def _central_gradient_sq(c):
    g2 = np.zeros_like(c)
    for ax in range(c.ndim):
        g = np.zeros_like(c)
        sl_mid = [slice(None)] * c.ndim
        sl_up = [slice(None)] * c.ndim
        sl_dn = [slice(None)] * c.ndim
        sl_mid[ax] = slice(1, -1)
        sl_up[ax] = slice(2, None)
        sl_dn[ax] = slice(None, -2)
        g[tuple(sl_mid)] = (c[tuple(sl_up)] - c[tuple(sl_dn)]) / 2
        g2 += g ** 2
    return g2


def m_gradient(grid, rng, c=None, m0=1.0, gamma=1.0, epsilon=1e-6):
    """m elevated where |∇c|² is large (m_fields_2d.py:39-49)."""
    if c is None:
        raise ValueError("m_gradient requires a c field")
    g2 = _central_gradient_sq(np.asarray(c, float))
    return m0 * (1 + gamma * g2 / (g2 + epsilon ** 2))


def m_phase_shifted(grid, rng, c=None, m0=1.0, delta=0.5,
                    shift_fraction=0.05):
    """m from normalized roll-difference magnitude of c
    (m_fields_2d.py:51-68)."""
    if c is None:
        raise ValueError("m_phase_shifted requires a c field")
    c = np.asarray(c, float)
    n = min(c.shape)
    shift = max(1, int(shift_fraction * n))
    mag = np.zeros_like(c)
    for ax in range(c.ndim):
        d = np.roll(c, shift, axis=ax) - np.roll(c, -shift, axis=ax)
        mag += d ** 2
    mag = np.sqrt(mag)
    return m0 * (1 + delta * mag / np.max(np.abs(mag)))


def m_topological(grid, rng, c=None, m0=1.0, eta=0.8, lambda_param=0.5):
    """Sign of (Δc - λ c), smoothed and normalized (m_fields_2d.py:70-81)."""
    if c is None:
        raise ValueError("m_topological requires a c field")
    c = np.asarray(c, float)
    topo = np.sign(laplace(c) - lambda_param * c)
    smooth = gaussian_filter(topo, sigma=1.0)
    return m0 * (1 + eta * smooth / np.max(np.abs(smooth)))


def m_defects(grid, rng, m0=1.0, num_defects=10, min_strength=-0.5,
              max_strength=1.0, min_width=0.05, max_width=0.2):
    """Random Gaussian bumps/dips, floored at 0.1 m0 (m_fields_2d.py:83-102)."""
    coords = _coords(grid)
    m = np.ones_like(coords[0]) * m0
    for _ in range(num_defects):
        center = rng.uniform(-grid.L, grid.L, len(coords))
        strength = rng.uniform(min_strength, max_strength) * m0
        width = rng.uniform(min_width, max_width) * grid.L
        r2 = sum((X - c0) ** 2 for X, c0 in zip(coords, center))
        m = m + strength * np.exp(-r2 / (2 * width ** 2))
    return np.maximum(m, 0.1 * m0)


def m_quasiperiodic(grid, rng, m0=1.0, num_waves=5, min_amp=0.1, max_amp=0.5):
    return np.maximum(
        _quasi_periodic(grid, rng, m0, num_waves, min_amp * m0, max_amp * m0),
        0.1 * m0)


def m_multiscale(grid, rng, m0=1.0, num_scales=4, min_scale=2, max_scale=16,
                 min_amp=0.1, max_amp=0.5):
    """Log-spaced smoothing scales of unit-normalized noise
    (m_fields_2d.py:130-145)."""
    shape = _coords(grid)[0].shape
    m = np.ones(shape) * m0
    for scale in np.logspace(np.log10(min_scale), np.log10(max_scale),
                             num_scales):
        noise = gaussian_filter(rng.standard_normal(shape), sigma=scale)
        amp = rng.uniform(min_amp, max_amp) * m0
        m = m + amp * noise / np.max(np.abs(noise))
    return np.maximum(m, 0.1 * m0)


M_FIELD_TYPES = {
    "constant": m_constant,
    "piecewise": m_piecewise,
    "gradient": m_gradient,
    "phase": m_phase_shifted,
    "topological": m_topological,
    "defects": m_defects,
    "quasiperiodic": m_quasiperiodic,
    "multiscale": m_multiscale,
}

_NEEDS_C = {"gradient", "phase", "topological"}


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def c_field(kind, grid, rng=None, **params):
    rng = rng if rng is not None else np.random.default_rng()
    kind = _C_ALIASES.get(kind, kind)
    return np.asarray(C_FIELD_TYPES[kind](grid, rng, **params), np.float64)


def m_field(kind, grid, rng=None, c=None, **params):
    rng = rng if rng is not None else np.random.default_rng()
    if kind in _NEEDS_C:
        params["c"] = c
    return np.asarray(M_FIELD_TYPES[kind](grid, rng, **params), np.float64)


def _random_c_params(kind, rng):
    """Hyper-parameter draws matching generate_c_fields
    (c_fields_2d.py:180-242)."""
    return {
        "constant": lambda: {},
        "periodic": lambda: {"amplitude": rng.uniform(0.2, 0.5),
                             "frequency": int(rng.integers(1, 3))},
        "piecewise_layers": lambda: {
            "num_layers": int(rng.integers(2, 5)),
            "contrast_factor": rng.uniform(1.5, 2.5)},
        "sign_changing": lambda: {
            "regions": ["checkerboard", "half_space"][rng.integers(2)],
            "scale": int(rng.integers(2, 3)),
            "sharpness": rng.uniform(3, 6)},
        "layered": lambda: {"num_layers": int(rng.integers(2, 6)),
                            "min_amplitude": rng.uniform(0.1, 0.3),
                            "max_amplitude": rng.uniform(0.4, 0.8),
                            "min_freq": rng.uniform(1, 3),
                            "max_freq": rng.uniform(5, 15)},
        "waveguide": lambda: {"min_width": rng.uniform(0.1, 0.3),
                              "max_width": rng.uniform(0.4, 0.8),
                              "guide_amplitude": rng.uniform(0.5, 2.0)},
        "quasiperiodic": lambda: {"num_waves": int(rng.integers(3, 8)),
                                  "min_amp": rng.uniform(0.1, 0.3),
                                  "max_amp": rng.uniform(0.4, 0.8)},
        "turbulent": lambda: {"intensity": rng.uniform(0.3, 0.8),
                              "min_scale": rng.uniform(1, 3),
                              "max_scale": rng.uniform(10, 30),
                              "beta": rng.uniform(1, 3),
                              "num_octaves": int(rng.integers(3, 8))},
    }[kind]()


def _random_m_params(kind, rng):
    """Hyper-parameter draws matching generate_m_fields
    (m_fields_2d.py:156-229)."""
    return {
        "constant": lambda: {},
        "piecewise": lambda: {
            "boundary_type": ["circle", "square", "horizontal", "vertical",
                              "diagonal"][rng.integers(5)],
            "boundary_param": rng.uniform(0.3, 0.7),
            "smooth_width": rng.uniform(0.01, 0.1)},
        "gradient": lambda: {"gamma": rng.uniform(0.5, 2.0),
                             "epsilon": rng.uniform(1e-3, 1e-1)},
        "phase": lambda: {"delta": rng.uniform(0.3, 1.0),
                          "shift_fraction": rng.uniform(0.02, 0.1)},
        "topological": lambda: {"eta": rng.uniform(0.5, 1.0),
                                "lambda_param": rng.uniform(0.3, 0.7)},
        "defects": lambda: {"num_defects": int(rng.integers(5, 20)),
                            "min_strength": rng.uniform(-0.5, -0.1),
                            "max_strength": rng.uniform(0.5, 1.0),
                            "min_width": rng.uniform(0.03, 0.08),
                            "max_width": rng.uniform(0.1, 0.3)},
        "quasiperiodic": lambda: {"num_waves": int(rng.integers(3, 8)),
                                  "min_amp": rng.uniform(0.1, 0.3),
                                  "max_amp": rng.uniform(0.4, 0.8)},
        "multiscale": lambda: {"num_scales": int(rng.integers(3, 6)),
                               "min_scale": rng.uniform(1, 3),
                               "max_scale": rng.uniform(8, 20),
                               "min_amp": rng.uniform(0.1, 0.3),
                               "max_amp": rng.uniform(0.4, 0.8)},
    }[kind]()


def sample_c_field(grid, rng, kind=None, base_value=1.0):
    """(field, params): random type + randomized hyper-parameters."""
    if kind is None:
        kinds = list(C_FIELD_TYPES)
        kind = kinds[rng.integers(len(kinds))]
    kind = _C_ALIASES.get(kind, kind)
    params = _random_c_params(kind, rng)
    field_ = c_field(kind, grid, rng, base_value=base_value, **params)
    return field_, dict(type=kind, **params)


def sample_m_field(grid, rng, kind=None, c=None, m0=1.0):
    """(field, params); c-derived kinds fall back to constant without c."""
    if kind is None:
        kinds = [k for k in M_FIELD_TYPES if c is not None
                 or k not in _NEEDS_C]
        kind = kinds[rng.integers(len(kinds))]
    if kind in _NEEDS_C and c is None:
        kind = "constant"
    params = _random_m_params(kind, rng)
    field_ = m_field(kind, grid, rng, c=c, m0=m0, **params)
    return field_, dict(type=kind, m0=m0, **params)
