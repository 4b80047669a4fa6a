"""NLSE densities rho(u) (port of nlsolvers_tpu/models/nonlinearities.py).

  cubic:          rho = m |u|^2               (nlse_cubic_solver.hpp:62-66)
  cubic_quintic:  rho = m (s1 |u|^2 + s2 |u|^4)
  saturable:      rho = m |u|^2 / (1 + kappa |u|^2), the device form
                  (nlse_saturating.cuh:13-18); with host_compat=True the
                  reference host's form m |u|^2 / (1 + kappa u)
                  (nlse_saturating_solver.hpp:17-18), a complex "density"
                  kept for parity studies only.

Real-wave g(u) of u_tt = Lap u - m g(u), the code's forms where the
reference's header comments differ:
  sine_gordon:             g = sin u             (sg_single_solver.hpp:54)
  double_sine_gordon:      g = sin u + 0.6 sin 2u (sg_double_solver.hpp:17-18;
                           the header says sin u + sin u/2)
  hyperbolic_sine_gordon:  g = sinh u            (sg_hyperbolic_solver.hpp:17-18)
  klein_gordon:            g = u^3, so the force is -m u^3 (kg_solver.hpp:8,17;
                           the header says m u)
  phi4:                    g = u - u^3           (phi4_solver.hpp:17-18)
and their potentials V(u) for an energy series, with the analysis tables'
phi4 and KG forms (0.5 u^4 for KG, u^2 - u^4 for phi4).
"""

import torch

__all__ = ["nlse_density", "nlse_density_planar", "PlanarDensity",
           "realwave_g", "realwave_potential", "NLSE_KINDS",
           "REALWAVE_KINDS"]

NLSE_KINDS = ("cubic", "cubic_quintic", "saturable")
REALWAVE_KINDS = ("sine_gordon", "double_sine_gordon",
                  "hyperbolic_sine_gordon", "klein_gordon", "phi4")


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
    (ops/cuda/kick.py). The (re, im) pair is axis -3 of up: (2, R, nx), or
    (B, 2, R, nx) for a batch whose lanes' m fields are m (B, R, nx)."""

    def __init__(self, kind, m, sigma1, sigma2, kappa):
        self.kind, self.m = kind, m
        self.sigma1, self.sigma2, self.kappa = sigma1, sigma2, kappa
        self._rho = _rho_of(kind, m, sigma1, sigma2, kappa)

    def __call__(self, up):
        re, im = up[..., 0, :, :], up[..., 1, :, :]
        return self._rho(re * re + im * im)


def nlse_density_planar(kind, m, *, sigma1=1.0, sigma2=-0.1, kappa=1.0):
    """rho(up) for PLANAR state up = (2, ...) stacked (re, im) float32 (a
    PlanarDensity). The device forms only: the host saturable form needs a
    complex density."""
    return PlanarDensity(kind, m, sigma1, sigma2, kappa)


def realwave_g(kind):
    """g(u) for u_tt = Lap u - m g(u)."""
    return {
        "sine_gordon": torch.sin,
        "double_sine_gordon": lambda u: torch.sin(u) + 0.6 * torch.sin(
            2.0 * u),
        "hyperbolic_sine_gordon": torch.sinh,
        "klein_gordon": lambda u: u ** 3,
        "phi4": lambda u: u - u ** 3,
    }[kind]


def realwave_potential(kind):
    """Potential energy density V(u) of an energy series: the analysis
    tables' forms (KG 0.5 u^4, phi4 u^2 - u^4) and the integral of g for
    the kinds they leave out."""
    return {
        "sine_gordon": lambda u: 1.0 - torch.cos(u),
        "double_sine_gordon": lambda u: (1.0 - torch.cos(u)
                                         + 0.3 * (1.0 - torch.cos(2.0 * u))),
        "hyperbolic_sine_gordon": lambda u: torch.cosh(u) - 1.0,
        "klein_gordon": lambda u: 0.5 * u ** 4,
        "phi4": lambda u: u ** 2 - u ** 4,
        "stochastic_phi4": lambda u: u ** 2 - u ** 4,
    }[kind]
