"""Trajectory classification features + dashboard figure.

Port of SolitonDashboard (scripts_sge_kge/classify_trajectory.py:8-230):
per-trajectory feature extraction (energy decomposition with per-system
potentials, norm conservation, operator-term magnitudes, center-of-mass
trajectory/velocity, final-frame power spectrum, localization, rotational
symmetry, stability) plus a compact matplotlib dashboard. Vectorized over
snapshots instead of per-frame Python loops.

Potential forms per system follow the reference's second (effective) table
(classify_trajectory.py:205-222): SG 1-cos u, double-SG + (0.6/2)(1-cos 2u),
hyperbolic cosh u - 1, KG u^2/2, phi4 (u^2-1)^2/4.

The port's copy of nlsolvers_tpu/analysis/classify.py (numpy, with
matplotlib imported by the dashboard only, as there).
"""

import numpy as np

__all__ = ["trajectory_features", "classification_dashboard", "POTENTIALS"]

POTENTIALS = {
    "sine_gordon": lambda u: 1 - np.cos(u),
    "double_sine_gordon": lambda u: (1 - np.cos(u))
    + (0.6 / 2) * (1 - np.cos(2 * u)),
    "hyperbolic_sine_gordon": lambda u: np.cosh(u) - 1,
    "klein_gordon": lambda u: 0.5 * u ** 2,
    "phi4": lambda u: (u ** 2 - 1) ** 2 / 4,
}


def trajectory_features(u, dx, dy, dt, system_type, v=None, X=None, Y=None):
    """Feature dict for a real snapshot stack u (S, ny, nx).

    dt here is the snapshot spacing (the reference passes its solver dt and
    divides COM drift by S*dt, classify_trajectory.py:155-157 — same units as
    long as callers are consistent).
    """
    u = np.asarray(u)
    S, ny, nx = u.shape
    dV = dx * dy
    if X is None or Y is None:
        x = (np.arange(nx) - (nx - 1) / 2) * dx
        y = (np.arange(ny) - (ny - 1) / 2) * dy
        X, Y = np.meshgrid(x, y, indexing="ij")

    if system_type not in POTENTIALS:
        raise ValueError(f"invalid system type {system_type!r}")
    pot = np.sum(POTENTIALS[system_type](u), axis=(1, 2)) * dV

    kinetic = (0.5 * np.sum(v ** 2, axis=(1, 2)) * dV if v is not None
               else np.full(S, np.nan))
    gx = np.gradient(u, dx, axis=1)
    gy = np.gradient(u, dy, axis=2)
    gradient = 0.5 * np.sum(gx ** 2 + gy ** 2, axis=(1, 2)) * dV

    # operator-term magnitudes (classify_trajectory.py:163-172)
    lap = (np.gradient(np.gradient(u, dx, axis=1), dx, axis=1)
           + np.gradient(np.gradient(u, dy, axis=2), dy, axis=2))
    laplacian = (np.sum(lap, axis=(1, 2)) * dV) ** 2
    nonlinear = np.sum(np.sin(u), axis=(1, 2)) * dV
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(nonlinear > 0, laplacian / nonlinear, 0.0)

    mass = np.sum(u ** 2, axis=(1, 2))
    com_den = np.sum(u, axis=(1, 2))
    with np.errstate(divide="ignore", invalid="ignore"):
        com = np.stack([np.sum(X * u, axis=(1, 2)) / com_den,
                        np.sum(Y * u, axis=(1, 2)) / com_den], axis=1)
    velocity = (com[-1, 0] - com[0, 0]) / (S * dt)

    final = u[-1]
    rotated = np.rot90(final)
    symmetry = np.corrcoef(final.ravel(), rotated.ravel())[0, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        stability = np.std(np.where(u[0] != 0, final / u[0], 0.0))

    return {
        "energy": (kinetic, gradient, pot),
        "conservation": {"norm": mass / mass[0]},
        "terms": {"laplacian": laplacian, "nonlinear": nonlinear,
                  "ratio": ratio},
        "trajectory": com,
        "power_spectrum": np.abs(np.fft.fftshift(np.fft.fft2(final))) ** 2,
        "velocity": velocity,
        "localization": np.max(final) / np.mean(np.abs(final)),
        "symmetry": symmetry,
        "stability": stability,
    }


def classification_dashboard(u, dx, dy, dt, system_type, out_path, v=None,
                             name=""):
    """Render the 3x3 dashboard figure (states / dynamics / analysis panels,
    create_dashboard at classify_trajectory.py:24-140)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    f = trajectory_features(u, dx, dy, dt, system_type, v=v)
    S = u.shape[0]
    fig, axes = plt.subplots(3, 3, figsize=(14, 12))

    vmin, vmax = np.nanmin(u), np.nanmax(u)
    for ax, t in zip(axes[0], [0, S // 2, S - 1]):
        im = ax.imshow(u[t], origin="lower", cmap="RdBu_r",
                       vmin=vmin, vmax=vmax)
        ax.set_title(f"state t={t}")
        fig.colorbar(im, ax=ax, shrink=0.7)

    kin, grad, pot = f["energy"]
    axes[1, 0].plot(grad, label="gradient")
    axes[1, 0].plot(pot, label="potential")
    if np.isfinite(kin).any():
        axes[1, 0].plot(kin, label="kinetic")
    axes[1, 0].legend()
    axes[1, 0].set_title("energy terms")

    axes[1, 1].plot(f["conservation"]["norm"])
    axes[1, 1].set_title("norm / norm0")

    com = f["trajectory"]
    axes[1, 2].plot(com[:, 0], com[:, 1], ".-")
    axes[1, 2].set_title(f"COM (v={f['velocity']:.3g})")

    axes[2, 0].imshow(np.log10(f["power_spectrum"] + 1e-12),
                      origin="lower", cmap="magma")
    axes[2, 0].set_title("log power spectrum (final)")

    axes[2, 1].plot(f["terms"]["laplacian"], label="laplacian")
    axes[2, 1].plot(f["terms"]["nonlinear"], label="nonlinear")
    axes[2, 1].legend()
    axes[2, 1].set_title("operator terms")

    axes[2, 2].axis("off")
    axes[2, 2].text(0.05, 0.7,
                    f"localization: {f['localization']:.3g}\n"
                    f"symmetry:     {f['symmetry']:.3g}\n"
                    f"stability:    {f['stability']:.3g}",
                    family="monospace", fontsize=12)
    fig.suptitle(f"{name} [{system_type}]")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return f
