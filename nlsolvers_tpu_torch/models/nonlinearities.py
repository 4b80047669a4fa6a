"""NLSE densities rho(u) (port of nlsolvers_tpu/models/nonlinearities.py).

  cubic:          rho = m |u|^2               (nlse_cubic_solver.hpp:62-66)
  cubic_quintic:  rho = m (s1 |u|^2 + s2 |u|^4)
  saturable:      rho = m |u|^2 / (1 + kappa |u|^2), the device form
                  (nlse_saturating.cuh:13-18); with host_compat=True the
                  reference host's form m |u|^2 / (1 + kappa u)
                  (nlse_saturating_solver.hpp:17-18), a complex "density"
                  kept for parity studies only.

The real-wave g(u) is not ported yet (ROADMAP.md queue 1, item 9).
"""

__all__ = ["nlse_density", "nlse_density_planar", "PlanarDensity",
           "NLSE_KINDS"]

NLSE_KINDS = ("cubic", "cubic_quintic", "saturable")


def _rho_of(kind, m, sigma1, sigma2, kappa):
    if kind == "cubic":
        return lambda a: m * a
    if kind == "cubic_quintic":
        return lambda a: m * (sigma1 * a + sigma2 * a * a)
    if kind == "saturable":
        return lambda a: m * a / (1.0 + kappa * a)
    raise ValueError(f"unknown NLSE kind {kind!r}")


def nlse_density(kind, m, *, sigma1=1.0, sigma2=-0.1, kappa=1.0,
                 host_compat=False):
    """rho(u) of a complex field u: a real field, or a complex one for the
    saturable host form (host_compat=True)."""
    if kind == "saturable" and host_compat:
        return lambda u: m * (u.real ** 2 + u.imag ** 2) / (1.0 + kappa * u)
    rho = _rho_of(kind, m, sigma1, sigma2, kappa)
    return lambda u: rho(u.real ** 2 + u.imag ** 2)


class PlanarDensity:
    """rho(up) of a planar state, which also carries (kind, m, sigma1,
    sigma2, kappa), so that a kernel can compute it in place
    (ops/cuda/kick.py)."""

    def __init__(self, kind, m, sigma1, sigma2, kappa):
        self.kind, self.m = kind, m
        self.sigma1, self.sigma2, self.kappa = sigma1, sigma2, kappa
        self._rho = _rho_of(kind, m, sigma1, sigma2, kappa)

    def __call__(self, up):
        return self._rho(up[0] * up[0] + up[1] * up[1])


def nlse_density_planar(kind, m, *, sigma1=1.0, sigma2=-0.1, kappa=1.0):
    """rho(up) for PLANAR state up = (2, ...) stacked (re, im) float32 (a
    PlanarDensity). The device forms only: the host saturable form needs a
    complex density."""
    return PlanarDensity(kind, m, sigma1, sigma2, kappa)
