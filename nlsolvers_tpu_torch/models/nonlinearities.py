"""NLSE densities rho(u) (port of nlsolvers_tpu/models/nonlinearities.py).

  cubic:          rho = m |u|^2               (nlse_cubic_solver.hpp:62-66)
  cubic_quintic:  rho = m (s1 |u|^2 + s2 |u|^4)
  saturable:      rho = m |u|^2 / (1 + kappa |u|^2), the device form
                  (nlse_saturating.cuh:13-18)

The reference host's saturable quirk (`host_compat`) and the real-wave g(u)
are not ported yet (ROADMAP.md queue 1, items 6 and 9).
"""

__all__ = ["nlse_density", "nlse_density_planar", "NLSE_KINDS"]

NLSE_KINDS = ("cubic", "cubic_quintic", "saturable")


def _rho_of(kind, m, sigma1, sigma2, kappa):
    if kind == "cubic":
        return lambda a: m * a
    if kind == "cubic_quintic":
        return lambda a: m * (sigma1 * a + sigma2 * a * a)
    if kind == "saturable":
        return lambda a: m * a / (1.0 + kappa * a)
    raise ValueError(f"unknown NLSE kind {kind!r}")


def nlse_density(kind, m, *, sigma1=1.0, sigma2=-0.1, kappa=1.0):
    """rho(u) (a real field) of a complex field u."""
    rho = _rho_of(kind, m, sigma1, sigma2, kappa)
    return lambda u: rho(u.real ** 2 + u.imag ** 2)


def nlse_density_planar(kind, m, *, sigma1=1.0, sigma2=-0.1, kappa=1.0):
    """rho(up) for PLANAR state up = (2, ...) stacked (re, im) float32."""
    rho = _rho_of(kind, m, sigma1, sigma2, kappa)
    return lambda up: rho(up[0] * up[0] + up[1] * up[1])
