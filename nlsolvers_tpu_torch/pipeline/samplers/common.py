"""Machinery shared by all phenomenon samplers: spatial arrangements, phase
patterns, and diversity-filtered ensemble generation.

The reference re-implements these inline in every multi-X sampler method
(nlse_sampler.py:112-161 and again at 855-941; real_sampler.py:316-336, ...);
here they are single functions parameterized by dimension.
"""

import numpy as np

__all__ = ["arrange_positions", "assign_phases", "l2_distance",
           "spectral_distance", "diverse_ensemble", "ensemble"]


def _fibonacci_sphere(i, n):
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return (np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
            np.cos(phi))


def arrange_positions(rng, n, arrangement, L, separation=5.0,
                      position_variance=1.0, cluster_levels=1, dim=2):
    """Centers for n objects. Arrangements (superset over both reference
    samplers): random, linear, circular, lattice, square, triangular,
    spherical (3D), planar_grid (3D), hierarchical, concentric, quasicrystal.
    Returns an (n, dim) array."""
    pts = []
    if arrangement == "linear":
        for i in range(n):
            p = [0.0] * dim
            p[0] = (i - (n - 1) / 2) * separation
            pts.append(p)
    elif arrangement == "circular":
        for i in range(n):
            a = 2 * np.pi * i / n
            p = [separation * np.cos(a), separation * np.sin(a)] \
                + [0.0] * (dim - 2)
            pts.append(p)
    elif arrangement in ("lattice", "square") and dim == 2 \
            or arrangement == "planar_grid":
        side = int(np.ceil(np.sqrt(n)))
        for i in range(side):
            for j in range(side):
                if len(pts) < n:
                    pts.append([(i - (side - 1) / 2) * separation,
                                (j - (side - 1) / 2) * separation]
                               + [0.0] * (dim - 2))
    elif arrangement == "lattice":  # 3D cubic
        side = int(np.ceil(n ** (1 / 3)))
        for i in range(side):
            for j in range(side):
                for k in range(side):
                    if len(pts) < n:
                        pts.append([(i - (side - 1) / 2) * separation,
                                    (j - (side - 1) / 2) * separation,
                                    (k - (side - 1) / 2) * separation])
    elif arrangement == "triangular":
        rows = int(np.ceil(np.sqrt(n * 2 / np.sqrt(3))))
        per_row = int(np.ceil(n / rows))
        for i in range(rows):
            off = (i % 2) * 0.5 * separation
            for j in range(per_row):
                if len(pts) < n:
                    pts.append([(j - (per_row - 1) / 2) * separation + off,
                                (i - (rows - 1) / 2) * separation
                                * np.sqrt(3) / 2] + [0.0] * (dim - 2))
    elif arrangement == "spherical":
        for i in range(n):
            pts.append([separation * c for c in _fibonacci_sphere(i, n)])
    elif arrangement == "concentric":
        pts = [[0.0] * dim for _ in range(n)]
    elif arrangement == "quasicrystal":
        symmetry = int(rng.choice([5, 7, 8, 9, 11]))
        for i in range(n):
            shell, idx = divmod(i, symmetry)
            if shell >= 3:
                break
            a = 2 * np.pi * idx / symmetry
            pts.append([separation * (shell + 1) * np.cos(a),
                        separation * (shell + 1) * np.sin(a)]
                       + [0.0] * (dim - 2))
    elif arrangement == "hierarchical":
        if cluster_levels <= 1:
            centers = [[0.0] * dim]
        elif dim == 2:
            centers = [[2 * separation * np.cos(2 * np.pi * i
                                                / cluster_levels),
                        2 * separation * np.sin(2 * np.pi * i
                                                / cluster_levels)]
                       for i in range(cluster_levels)]
        else:
            centers = [[2 * separation * c for c in
                        _fibonacci_sphere(i, cluster_levels)]
                       for i in range(cluster_levels)]
        per, rem = divmod(n, len(centers))
        for ci, c in enumerate(centers):
            size = per + (1 if ci < rem else 0)
            for j in range(size):
                if j == 0 and cluster_levels > 1:
                    pts.append(list(c))
                elif dim == 2:
                    a = 2 * np.pi * j / size
                    pts.append([c[0] + 0.5 * separation * np.cos(a),
                                c[1] + 0.5 * separation * np.sin(a)])
                else:
                    off = _fibonacci_sphere(j, size)
                    pts.append([ci_ + 0.5 * separation * o
                                for ci_, o in zip(c, off)])
    else:  # random
        pts = rng.normal(0.0, position_variance * L / 4,
                         (n, dim)).tolist()
    return np.asarray(pts[:n], float)


def assign_phases(rng, positions, pattern, coherence=0.8, phase_value=0.0):
    """Per-object phases: random / alternating / synchronized / vortex /
    3d_vortex / radial / spiral / z_dependent / partial_coherence
    (nlse_sampler.py:163-180, 950-990)."""
    n = len(positions)
    center = positions.mean(axis=0)
    rel = positions - center
    if pattern == "random":
        return rng.uniform(0, 2 * np.pi, n)
    if pattern == "alternating":
        return np.arange(n) * np.pi
    if pattern == "synchronized":
        return np.full(n, phase_value)
    if pattern == "vortex":
        return np.arctan2(rel[:, 1], rel[:, 0])
    if pattern == "3d_vortex":
        r = np.linalg.norm(rel, axis=1)
        theta = np.arccos(rel[:, 2] / np.maximum(r, 1e-10))
        return np.arctan2(rel[:, 1], rel[:, 0]) + theta
    if pattern == "radial":
        return np.linalg.norm(rel, axis=1)
    if pattern == "spiral":
        return (np.arctan2(rel[:, 1], rel[:, 0])
                + np.linalg.norm(rel, axis=1))
    if pattern == "z_dependent":
        return rel[:, 2].copy()
    if pattern == "partial_coherence":
        base = rng.uniform(0, 2 * np.pi)
        return np.where(rng.random(n) < coherence, base,
                        rng.uniform(0, 2 * np.pi, n))
    raise ValueError(f"unknown phase pattern {pattern!r}")


def _flat_parts(sample):
    """Normalize a sample (array or (u, v) tuple) to a list of real arrays."""
    if isinstance(sample, tuple):
        return [np.asarray(p) for p in sample]
    return [np.asarray(sample)]


def l2_distance(s1, s2):
    """Unit-normalized L2 distance; tuples are averaged component-wise
    (real_sampler.py:1535-1550, nlse_sampler.py:653-659)."""
    p1, p2 = _flat_parts(s1), _flat_parts(s2)
    n1 = np.sqrt(sum(np.sum(np.abs(p) ** 2) for p in p1))
    n2 = np.sqrt(sum(np.sum(np.abs(p) ** 2) for p in p2))
    if n1 == 0 or n2 == 0:
        return 1.0
    dists = [np.sqrt(np.sum(np.abs(a / n1 - b / n2) ** 2))
             for a, b in zip(p1, p2)]
    return float(np.mean(dists))


def spectral_distance(s1, s2):
    """1 - normalized |FFT| overlap (nlse_sampler.py:660-670)."""
    p1, p2 = _flat_parts(s1), _flat_parts(s2)
    overlaps = []
    for a, b in zip(p1, p2):
        fa, fb = np.abs(np.fft.fftn(a)), np.abs(np.fft.fftn(b))
        na, nb = np.linalg.norm(fa), np.linalg.norm(fb)
        if na == 0 or nb == 0:
            return 1.0
        overlaps.append(np.sum(fa * fb) / (na * nb))
    return float(1.0 - np.mean(overlaps))


DIVERSITY_METRICS = {"l2": l2_distance, "spectral": spectral_distance}


def ensemble(draw, n_samples):
    """n_samples independent draws; one bare sample when n_samples == 1
    (the reference's ensemble contract, nlse_sampler.py:639-642)."""
    samples = [draw() for _ in range(n_samples)]
    return samples[0] if n_samples == 1 else samples


def diverse_ensemble(draw, n_samples, similarity_threshold=0.2,
                     max_attempts=100, diversity_metric="l2",
                     normalize=None):
    """Rejection-sample until n_samples pairwise-diverse draws are collected.

    `draw()` produces one sample (array or (u, v) tuple); non-finite draws
    are discarded (the reference's NaN guard, nlse_sampler.py:721-725).
    """
    dist = DIVERSITY_METRICS[diversity_metric]
    samples, attempts = [], 0
    while len(samples) < n_samples and attempts < max_attempts:
        attempts += 1
        sample = draw()
        if not all(np.all(np.isfinite(p)) for p in _flat_parts(sample)):
            continue
        if any(dist(sample, s) < similarity_threshold for s in samples):
            continue
        if normalize is not None:
            sample = normalize(sample)
        samples.append(sample)
    return samples


def embed_ensemble(samples, perplexity=30, n_iter=1000, random_state=42):
    """2D t-SNE embedding of sampled ICs for diversity visualization
    (tsne_complex_fields, nlse_sampler.py:737-748; real variant
    real_sampler.py:1626-1640). Complex fields embed as [|u|, arg(u)]
    features; real (u, v) tuples embed their concatenated flats."""
    from sklearn.manifold import TSNE

    features = []
    for sample in samples:
        parts = _flat_parts(sample)
        flat = np.concatenate([p.ravel() for p in parts])
        if np.iscomplexobj(flat):
            flat = np.concatenate([np.abs(flat), np.angle(flat)])
        features.append(flat)
    features = np.asarray(features, np.float64)
    perplexity = min(perplexity, max(1, len(samples) - 1))
    # method="exact": the default Barnes-Hut C path segfaults alongside this
    # environment's OpenMP runtime; ensembles are small so exact is fine.
    tsne = TSNE(n_components=2, perplexity=perplexity, max_iter=n_iter,
                random_state=random_state, method="exact")
    return tsne.fit_transform(features)


def plot_embedding(embedding, out_path, labels=None, title="IC diversity"):
    """Scatter plot of an ensemble embedding."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    sc = ax.scatter(embedding[:, 0], embedding[:, 1],
                    c=(labels if labels is not None else None), s=30)
    if labels is not None:
        fig.colorbar(sc, ax=ax, shrink=0.8)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
