"""Closed-form energy/mass functionals for every equation family.

Host-side numpy ports of the reference's two metric vocabularies, kept
separately because their discretizations differ and both are used as gates:

* `energy_terms` — the ensemble post-processing decomposition
  (process_h5/ensemble_processing.py:48-89): np.gradient-based gradient term,
  per problem_type closed forms, returning (total, kinetic, gradient,
  potential). NOTE the reference forms deliberately ignore c(x) and m(x)
  (documented there), and the NLSE "cubic" form has no kinetic term.

* `mass_nlse`, `hamiltonian_nlse`, `hamiltonian_kge_u_cubed` — the
  integrator-study metrics (compare_utils_complex_2d.py:134-153,
  compare_utils_real_2d.py:112-131): interior central differences, optional
  c(x) weighting, m(x)-weighted quartic potential for KG.

All functions accept a trailing snapshot stack: fields shaped (*, ny, nx) or
(*, nz, ny, nx) are reduced over the spatial axes only.

The port's copy of nlsolvers_tpu/analysis/energy.py (numpy on the host,
as there: the same arrays in give equal arrays out).
"""

import numpy as np

__all__ = ["energy_terms", "mass_nlse", "hamiltonian_nlse",
           "hamiltonian_kge_u_cubed", "gradient_sq_norm"]


def _spatial_axes(dim):
    return tuple(range(-dim, 0))


def _grad_sq_gradient(u, spacings):
    """|grad u|^2 via np.gradient along the trailing len(spacings) axes."""
    dim = len(spacings)
    axes = _spatial_axes(dim)
    grads = np.gradient(u, *spacings, axis=axes)
    if dim == 1:
        grads = [grads]
    return sum(np.abs(g) ** 2 for g in grads)


def energy_terms(u, v, spacings, problem_type):
    """(total, kinetic, gradient, potential) per snapshot.

    Parity: calculate_energy_terms (ensemble_processing.py:48-89). `u` may be
    a single snapshot or a stack; `v` may be None where unused (NLSE).
    """
    dim = len(spacings)
    axes = _spatial_axes(dim)
    dV = float(np.prod(spacings))
    grad2 = _grad_sq_gradient(u, spacings)

    def S(x):
        return np.sum(x, axis=axes) * dV

    if problem_type == "klein_gordon":
        kinetic = 0.5 * S(v ** 2)
        gradient = 0.5 * S(grad2)
        potential = 0.5 * S(u ** 4)
    elif problem_type == "cubic":
        kinetic = np.zeros(np.shape(u)[: u.ndim - dim])
        gradient = S(grad2)
        potential = -0.5 * S(np.abs(u) ** 4)
    elif problem_type == "sine_gordon":
        kinetic = 0.5 * S(v ** 2)
        gradient = 0.5 * S(grad2)
        potential = S(1.0 - np.cos(u))
    elif problem_type == "phi4":
        kinetic = 0.5 * S(v ** 2)
        gradient = 0.5 * S(grad2)
        potential = S(u ** 2 - u ** 4)
    else:
        nan = np.full(np.shape(u)[: u.ndim - dim], np.nan)
        return nan, nan.copy(), nan.copy(), nan.copy()
    total = kinetic + gradient + potential
    return total, kinetic, gradient, potential


def mass_nlse(u, spacings):
    """sum |u|^2 dV (compare_utils_complex_2d.py:142-143); also the L2 mass
    used for real fields (compare_utils_real_2d.py:124-125)."""
    return np.sum(np.abs(u) ** 2, axis=_spatial_axes(len(spacings))) \
        * float(np.prod(spacings))


def gradient_sq_norm(u, spacings, c=None):
    """Interior-central-difference sum of c |grad u|^2 dV
    (compare_utils_real_2d.py:112-122; complex variant :134-140 has c=1)."""
    dim = len(spacings)
    axes = _spatial_axes(dim)
    dV = float(np.prod(spacings))
    inner = tuple([Ellipsis] + [slice(1, -1)] * dim)
    total = 0.0
    for k, d in enumerate(spacings):
        ax = axes[k]
        lo = [slice(1, -1)] * dim
        hi = [slice(1, -1)] * dim
        lo[k] = slice(0, -2)
        hi[k] = slice(2, None)
        du = (u[tuple([Ellipsis] + hi)] - u[tuple([Ellipsis] + lo)]) \
            / (2.0 * d)
        total = total + np.abs(du) ** 2
    if c is not None:
        total = c[inner] * total
    return np.sum(total, axis=axes) * dV


def hamiltonian_nlse(u, spacings, m_eff=1.0):
    """(gradient, potential) of the standard cubic NLSE Hamiltonian
    (compare_utils_complex_2d.py:145-152): grad term unit-c interior central
    difference, potential -m_eff/2 |u|^4."""
    e_grad = gradient_sq_norm(u, spacings)
    e_pot = (-m_eff / 2.0) * np.sum(
        np.abs(u) ** 4, axis=_spatial_axes(len(spacings))) \
        * float(np.prod(spacings))
    return e_grad, e_pot


def hamiltonian_kge_u_cubed(u, ut, spacings, m=None, c=None):
    """(kinetic, gradient, potential) for the u^3 Klein-Gordon Hamiltonian
    (compare_utils_real_2d.py:127-131)."""
    axes = _spatial_axes(len(spacings))
    dV = float(np.prod(spacings))
    e_kin = 0.5 * np.sum(ut ** 2, axis=axes) * dV
    e_grad = 0.5 * gradient_sq_norm(u, spacings, c=c)
    quart = 0.25 * u ** 4
    if m is not None:
        quart = m * quart
    e_pot = np.sum(quart, axis=axes) * dV
    return e_kin, e_grad, e_pot
