"""Structural / information-theoretic trajectory diagnostics.

Ports of the reference's perf/structure comparison suite
(`nlsolvers/scripts_sge_kge/perf_refactored.py:40-126`) and the
persistent-homology piece of its info-theoretic analysis
(`nlsolvers/scripts/info_analysis.py:115-160`, which depends on ripser —
here replaced with a dependency-free union-find sublevel-set filtration).
Modal entropy and mutual information live in analysis/spectral.py.

All functions take numpy-convertible snapshot stacks shaped (S, ny, nx).

The port's copy of nlsolvers_tpu/analysis/structure.py (numpy on the
host, scipy imported where SSIM needs it, as there).
"""

import numpy as np

__all__ = ["modal_energy_grid", "structure_similarity",
           "observed_dispersion", "local_conservation",
           "sublevel_persistence"]


def modal_energy_grid(traj, n_modes=32):
    """|FFT|^2 on the centered n_modes x n_modes mode block per snapshot.

    Parity: perf_refactored.compute_modal_energy (:40-53), vectorized over
    time instead of the reference's quadruple python loop.
    """
    traj = np.asarray(traj)
    S, ny, nx = traj.shape
    spec = np.fft.fftshift(np.fft.fft2(traj, axes=(-2, -1)), axes=(-2, -1))
    cy, cx = ny // 2, nx // 2
    h = n_modes // 2
    block = spec[:, cy - h:cy - h + n_modes, cx - h:cx - h + n_modes]
    return np.abs(block) ** 2


def _ssim_pair(a, b, data_range, sigma=1.5):
    """SSIM of two 2D frames with a Gaussian window (skimage conventions:
    gaussian_weights=True, truncate 3.5, K1=0.01, K2=0.03)."""
    from scipy.ndimage import gaussian_filter

    a = a.astype(np.float64)
    b = b.astype(np.float64)
    trunc = 3.5
    filt = lambda x: gaussian_filter(x, sigma, truncate=trunc)
    K1, K2 = 0.01, 0.03
    C1, C2 = (K1 * data_range) ** 2, (K2 * data_range) ** 2
    mu_a, mu_b = filt(a), filt(b)
    va = filt(a * a) - mu_a ** 2
    vb = filt(b * b) - mu_b ** 2
    cab = filt(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + C1) * (2 * cab + C2)
    den = (mu_a ** 2 + mu_b ** 2 + C1) * (va + vb + C2)
    return float(np.mean(num / den))


def structure_similarity(traj, reference_frame=None):
    """SSIM of every snapshot against a reference frame (default: frame 0).

    Parity: perf_refactored.compute_structure_similarity (:56-70), with the
    same global data_range = max - min over the whole trajectory.
    """
    traj = np.asarray(traj)
    if reference_frame is None:
        reference_frame = traj[0]
    rng = float(traj.max() - traj.min())
    if rng == 0.0:
        return np.ones(traj.shape[0])
    return np.array([_ssim_pair(reference_frame, traj[t], rng)
                     for t in range(traj.shape[0])])


def observed_dispersion(traj, dx, dt, n_bins=50):
    """Observed dispersion relation from FFT phase evolution.

    Parity: perf_refactored.compute_spectral_dispersion (:73-104): the phase
    of FFT(u_t)/FFT(u_0) divided by t*dt, time-averaged over the first half
    of the trajectory, then radially binned in |k| up to pi/dx. Returns
    (k_centers, radial_mean, radial_std, dispersion_map).
    """
    traj = np.asarray(traj)
    S, ny, nx = traj.shape
    if ny != nx:
        raise ValueError("Expected square grid for dispersion analysis")
    k = 2 * np.pi * np.fft.fftfreq(nx, dx)
    k_mag = np.sqrt(k[:, None] ** 2 + k[None, :] ** 2)
    f0 = np.fft.fft2(traj[0])
    maps = []
    for t in range(1, S // 2 + 1):
        ratio = np.fft.fft2(traj[t]) / (f0 + 1e-10)
        maps.append(np.angle(ratio) / (t * dt))
    disp = np.mean(maps, axis=0)
    k_bins = np.linspace(0, np.pi / dx, n_bins)
    mean = np.zeros(n_bins - 1)
    std = np.zeros(n_bins - 1)
    for i in range(n_bins - 1):
        mask = (k_mag > k_bins[i]) & (k_mag <= k_bins[i + 1])
        if mask.any():
            mean[i] = disp[mask].mean()
            std[i] = disp[mask].std()
    centers = 0.5 * (k_bins[:-1] + k_bins[1:])
    return centers, mean, std, disp


def local_conservation(traj, vel, dt):
    """Mean |(u_t numerical) - v| per snapshot — the reference's local
    conservation check (perf_refactored.compute_local_conservation:107-126;
    its interior Laplacian is computed but unused there too)."""
    traj = np.asarray(traj)
    vel = np.asarray(vel)
    S = traj.shape[0]
    out = np.zeros(S)
    for t in range(1, S):
        ut_num = (traj[t] - traj[t - 1]) / dt
        out[t] = np.abs(ut_num[1:-1, 1:-1] - vel[t][1:-1, 1:-1]).mean()
    return out


def sublevel_persistence(field, n_levels=None):
    """0-dimensional persistent homology of the sublevel-set filtration.

    Dependency-free replacement for the reference's ripser call
    (info_analysis.persistent_homology_analysis): connected components of
    {u <= c} are tracked with union-find as the threshold sweeps upward;
    each component is born at its minimum and dies when it merges into an
    older component (elder rule). Returns an (n, 2) array of
    (birth, death) pairs; the global minimum's component has death = +inf.
    4-connectivity on the 2D grid.
    """
    f = np.asarray(field, np.float64)
    ny, nx = f.shape
    flat = f.ravel()
    order = np.argsort(flat, kind="stable")
    parent = np.full(ny * nx, -1, np.int64)
    comp_min = {}          # root -> birth value
    pairs = []

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    for idx in order:
        val = flat[idx]
        parent[idx] = idx
        comp_min[idx] = val
        y, x = divmod(int(idx), nx)
        for ny_, nx_ in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
            if not (0 <= ny_ < ny and 0 <= nx_ < nx):
                continue
            nidx = ny_ * nx + nx_
            if parent[nidx] < 0:        # neighbor not yet in filtration
                continue
            ra, rb = find(idx), find(nidx)
            if ra == rb:
                continue
            # elder rule: the younger component (larger birth) dies now
            if comp_min[ra] > comp_min[rb]:
                ra, rb = rb, ra
            pairs.append((comp_min[rb], val))
            parent[rb] = ra
            del comp_min[rb]
    roots = [r for r in comp_min]
    for r in roots:
        pairs.append((comp_min[r], np.inf))
    return np.asarray(sorted(pairs), np.float64)
