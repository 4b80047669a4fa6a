"""Shared sampling-grid geometry for the IC samplers and field generators.

Host-side (numpy): IC sampling happens once per trajectory on the host, so it
stays plain numpy with an explicit `np.random.Generator` everywhere — unlike
the reference samplers, which draw from the global `np.random` state
(finalized_scripts/nlse_sampler.py, real_sampler.py) and are therefore not
reproducible per-sample. The grid convention matches the solver drivers:
n points spanning [-L, L], dx = 2L/(n-1).
"""

from dataclasses import dataclass, field

import numpy as np

__all__ = ["Grid2D", "Grid3D", "sech", "rotate2d", "gaussian_random_field",
           "resolve_param_ranges"]


def sech(x):
    return 1.0 / np.cosh(x)


def rotate2d(X, Y, x0=0.0, y0=0.0, angle=0.0):
    """Coordinates relative to (x0, y0) rotated by `angle`."""
    c, s = np.cos(angle), np.sin(angle)
    Xr = (X - x0) * c + (Y - y0) * s
    Yr = -(X - x0) * s + (Y - y0) * c
    return Xr, Yr


@dataclass(frozen=True)
class Grid2D:
    nx: int
    ny: int
    L: float

    @property
    def x(self):
        return np.linspace(-self.L, self.L, self.nx)

    @property
    def y(self):
        return np.linspace(-self.L, self.L, self.ny)

    def mesh(self):
        return np.meshgrid(self.x, self.y, indexing="ij")

    @property
    def dx(self):
        return 2 * self.L / (self.nx - 1)

    @property
    def dy(self):
        return 2 * self.L / (self.ny - 1)

    @property
    def cell_area(self):
        return self.dx * self.dy

    def kmesh(self):
        kx = 2 * np.pi * np.fft.fftfreq(self.nx, self.dx)
        ky = 2 * np.pi * np.fft.fftfreq(self.ny, self.dy)
        return np.meshgrid(kx, ky, indexing="ij")

    def polar(self, x0=0.0, y0=0.0):
        X, Y = self.mesh()
        r = np.sqrt((X - x0) ** 2 + (Y - y0) ** 2)
        theta = np.arctan2(Y - y0, X - x0)
        return r, theta

    def envelope(self, u, width_factor=0.7):
        """Gaussian window suppressing support near the no-flux boundary
        (reference `_envelope`, nlse_sampler.py:29-32)."""
        r, _ = self.polar()
        w = width_factor * self.L
        return u * np.exp(-r ** 2 / (2 * w ** 2))


@dataclass(frozen=True)
class Grid3D:
    nx: int
    ny: int
    nz: int
    L: float

    @property
    def axes(self):
        return (np.linspace(-self.L, self.L, self.nx),
                np.linspace(-self.L, self.L, self.ny),
                np.linspace(-self.L, self.L, self.nz))

    def mesh(self):
        x, y, z = self.axes
        return np.meshgrid(x, y, z, indexing="ij")

    @property
    def dx(self):
        return 2 * self.L / (self.nx - 1)

    def kmesh(self):
        kx = 2 * np.pi * np.fft.fftfreq(self.nx, 2 * self.L / self.nx)
        ky = 2 * np.pi * np.fft.fftfreq(self.ny, 2 * self.L / self.ny)
        kz = 2 * np.pi * np.fft.fftfreq(self.nz, 2 * self.L / self.nz)
        return np.meshgrid(kx, ky, kz, indexing="ij")

    def envelope(self, u, width_factor=0.7):
        X, Y, Z = self.mesh()
        w = width_factor * self.L
        return u * np.exp(-(X ** 2 + Y ** 2 + Z ** 2) / w ** 2)


def _rot_spectrum_2d(KX, KY, theta_deg):
    t = np.deg2rad(theta_deg)
    return (KX * np.cos(t) - KY * np.sin(t),
            KX * np.sin(t) + KY * np.cos(t))


def gaussian_random_field(grid, rng, length_scale=1.0, anisotropy_ratio=2.0,
                          theta=30.0, power=2.0, amplitude=1.0):
    """Anisotropic GRF via spectral filtering of white noise.

    2D parity: real_sampler.py:48-65 (spectral envelope
    exp(-((k·ell)^2)^(p/2)) with rotated, ratio-scaled correlation lengths,
    normalized to unit std then scaled). For Grid3D, `anisotropy_ratio` and
    `theta` may be 2-tuples (xy, xz) matching real_sampler.py:1678-1711.
    """
    if isinstance(grid, Grid3D):
        aniso = np.broadcast_to(np.asarray(anisotropy_ratio, float), (2,))
        th = np.broadcast_to(np.asarray(theta, float), (3,))
        ell = (length_scale * np.sqrt(aniso[0] * aniso[1]),
               length_scale * np.sqrt(1.0 / aniso[0]),
               length_scale * np.sqrt(1.0 / aniso[1]))
        KX, KY, KZ = grid.kmesh()
        KX, KY = _rot_spectrum_2d(KX, KY, th[0])
        KX, KZ = _rot_spectrum_2d(KX, KZ, th[1])
        KY, KZ = _rot_spectrum_2d(KY, KZ, th[2])
        q = ((KX / ell[0]) ** 2 + (KY / ell[1]) ** 2
             + (KZ / ell[2]) ** 2)
        shape = (grid.nx, grid.ny, grid.nz)
    else:
        ell_x = length_scale * np.sqrt(anisotropy_ratio)
        ell_y = length_scale / np.sqrt(anisotropy_ratio)
        KX, KY = grid.kmesh()
        KX, KY = _rot_spectrum_2d(KX, KY, theta)
        q = (KX / ell_x) ** 2 + (KY / ell_y) ** 2
        shape = (grid.nx, grid.ny)

    spectrum = np.exp(-q ** (power / 2))
    noise = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    field_ = np.fft.ifftn(np.fft.fftn(noise) * np.sqrt(spectrum)).real
    return field_ / np.std(field_) * amplitude


def resolve_param_ranges(rng, parameter_ranges, fixed=None):
    """Draw one concrete parameter dict from a range specification.

    Spec semantics shared by all reference ensembles (nlse_sampler.py:604-616):
    list -> uniform choice; (int, int) tuple -> randint inclusive;
    (float, float) tuple -> uniform.
    """
    params = dict(fixed or {})
    for name, spec in (parameter_ranges or {}).items():
        if isinstance(spec, list):
            params[name] = spec[rng.integers(len(spec))]
        elif isinstance(spec, tuple) and len(spec) == 2:
            lo, hi = spec
            if isinstance(lo, (int, np.integer)) and isinstance(
                    hi, (int, np.integer)):
                params[name] = int(rng.integers(lo, hi + 1))
            else:
                params[name] = float(rng.uniform(lo, hi))
        else:
            raise ValueError(f"invalid range spec for {name!r}: {spec!r}")
    return params
