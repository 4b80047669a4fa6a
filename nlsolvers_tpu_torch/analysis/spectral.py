"""Spectral / information-theoretic trajectory diagnostics.

Vectorized ports of the reference's modal analysis
(scripts/info_analysis.py:19-116 — modal/frequency entropy, dominant modes,
regional mutual information) and the modal energy spectrum used by the
structure-comparison study (scripts_sge_kge/perf_refactored.py:29-126).
The persistent-homology and graph-network extras depended on optional
packages (ripser, networkx) and are intentionally out of scope; everything
here is numpy-only.

The port's copy of nlsolvers_tpu/analysis/spectral.py (numpy on the host,
as there).
"""

import numpy as np

__all__ = ["modal_energy_spectrum", "modal_decomposition_entropy",
           "spatiotemporal_mutual_information", "spectral_dispersion"]


def _entropy(p, axis=-1):
    """Shannon entropy of (possibly unnormalized) nonneg distributions."""
    p = p / np.clip(np.sum(p, axis=axis, keepdims=True), 1e-300, None)
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(p > 0, -p * np.log(p), 0.0)
    return np.sum(terms, axis=axis)


def modal_energy_spectrum(traj, n_bins=None):
    """Isotropic |FFT|^2 spectrum per snapshot, radially binned.

    Returns (k_centers, spectrum[S, n_bins]). traj: (S, ny, nx) real or
    complex (perf_refactored.py modal energy spectra)."""
    S, ny, nx = traj.shape
    power = np.abs(np.fft.fft2(traj, axes=(-2, -1))) ** 2
    ky = np.fft.fftfreq(ny)[:, None]
    kx = np.fft.fftfreq(nx)[None, :]
    kr = np.sqrt(kx ** 2 + ky ** 2)
    if n_bins is None:
        n_bins = min(ny, nx) // 2
    edges = np.linspace(0, kr.max() + 1e-12, n_bins + 1)
    which = np.clip(np.digitize(kr.ravel(), edges) - 1, 0, n_bins - 1)
    spec = np.zeros((S, n_bins))
    for b in range(n_bins):
        mask = which == b
        if mask.any():
            spec[:, b] = power.reshape(S, -1)[:, mask].sum(axis=1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, spec


def modal_decomposition_entropy(traj, dx, dy, n_dominant=3):
    """(modal_entropy[S], freq_entropy[S], dominant_modes[S, n, 2]) —
    info_analysis.py:19-55, vectorized over snapshots."""
    S, ny, nx = traj.shape
    power = np.abs(np.fft.fft2(traj, axes=(-2, -1))) ** 2
    flat = power.reshape(S, -1)
    modal_entropy = _entropy(flat)

    kx = 2 * np.pi * np.fft.fftfreq(nx, dx)
    ky = 2 * np.pi * np.fft.fftfreq(ny, dy)
    dominant = np.zeros((S, n_dominant, 2), dtype=int)
    freq_entropy = np.zeros(S)
    pc = flat.copy()
    pc[:, 0] = 0.0                        # zero the DC mode
    for i in range(n_dominant):
        idx = np.argmax(pc, axis=1)
        dominant[:, i, 0] = idx // nx
        dominant[:, i, 1] = idx % nx
        pc[np.arange(S), idx] = 0.0
    mags = np.sqrt(ky[dominant[:, :, 0]] ** 2 + kx[dominant[:, :, 1]] ** 2)
    nonzero = mags.sum(axis=1) > 0
    freq_entropy[nonzero] = _entropy(mags[nonzero])
    return modal_entropy, freq_entropy, dominant


def spatiotemporal_mutual_information(traj, n_regions=4, time_lag=1,
                                      bins=None):
    """Directed MI between |u| histograms of grid regions at a time lag —
    info_analysis.py:56-105. Returns (n_regions^2, n_regions^2) matrix."""
    traj = np.abs(np.asarray(traj))
    S, ny, nx = traj.shape
    ry, rx = ny // n_regions, nx // n_regions
    R = n_regions * n_regions
    usable = S - time_lag
    if usable < 1:
        return np.zeros((R, R))
    regions = np.empty((R, S, ry * rx))
    for i in range(n_regions):
        for j in range(n_regions):
            block = traj[:, i * ry:(i + 1) * ry, j * rx:(j + 1) * rx]
            regions[i * n_regions + j] = block.reshape(S, -1)

    if bins is None:
        bins = min(20, max(2, int(np.sqrt(usable))))
    mi = np.zeros((R, R))
    for i in range(R):
        for j in range(R):
            if i == j:
                continue
            di = regions[i, :usable]
            dj = regions[j, time_lag:time_lag + usable]
            vals = np.zeros(usable)
            for t in range(usable):
                hi, _ = np.histogram(di[t], bins=bins, density=True)
                hj, _ = np.histogram(dj[t], bins=bins, density=True)
                hij, _, _ = np.histogram2d(di[t], dj[t], bins=bins)
                hij = hij / max(hij.sum(), 1e-300)
                vals[t] = (_entropy(hi + 1e-10) + _entropy(hj + 1e-10)
                           - _entropy((hij + 1e-10).ravel()))
            mi[i, j] = vals.mean()
    return mi


def spectral_dispersion(traj, dx, dy):
    """Centroid wavenumber and spectral spread per snapshot — the dispersion
    diagnostics of perf_refactored.py."""
    S, ny, nx = traj.shape
    power = np.abs(np.fft.fft2(traj, axes=(-2, -1))) ** 2
    ky = 2 * np.pi * np.fft.fftfreq(ny, dy)[:, None]
    kx = 2 * np.pi * np.fft.fftfreq(nx, dx)[None, :]
    kr = np.sqrt(kx ** 2 + ky ** 2)
    tot = power.reshape(S, -1).sum(axis=1)
    tot = np.clip(tot, 1e-300, None)
    centroid = (power * kr).reshape(S, -1).sum(axis=1) / tot
    second = (power * kr ** 2).reshape(S, -1).sum(axis=1) / tot
    spread = np.sqrt(np.clip(second - centroid ** 2, 0.0, None))
    return centroid, spread
