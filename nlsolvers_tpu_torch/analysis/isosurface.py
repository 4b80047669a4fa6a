"""Dependency-free isosurface extraction (marching tetrahedra).

The reference's 3D animation (its animate_3d.py:5) renders
skimage marching-cubes isosurfaces; skimage is not in this environment, so
this module re-derives isosurface extraction from scratch as MARCHING
TETRAHEDRA: each grid cube splits into 6 tetrahedra sharing the 0-6
diagonal, and a tetrahedron's 16 sign cases reduce to three shapes (empty,
one triangle for 1-vs-3 splits, a two-triangle quad for 2-2 splits) that
are enumerable in a dozen lines — no 256-entry tables. The resulting mesh
is a valid, watertight-per-tet isosurface (slightly more triangles than
marching cubes for the same field).

Fully vectorized over cubes: ~350k tets of a 40^3 grid extract in tens of
milliseconds.

The port's copy of nlsolvers_tpu/analysis/isosurface.py (numpy, as
there).
"""

import numpy as np

__all__ = ["marching_tetrahedra"]

# cube corner offsets (dz, dy, dx), corner index = binary zyx
_CORNERS = np.array([(z, y, x) for z in (0, 1) for y in (0, 1)
                     for x in (0, 1)])

# 6-tetrahedra decomposition of the cube around the main diagonal 0-7
# (corner index = 4z + 2y + x): one tet per permutation of the three axis
# steps on the monotone path 0 -> 7, i.e. (0, step1, step1+step2, 7).
# Each has volume 1/6 and they tile the cube exactly (verified
# volumetrically + by point-coverage in tests/test_analysis.py).
_TETS = np.array([
    (0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
    (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7),
])


def _tet_cases():
    """case (4-bit inside mask) -> list of triangles, each a list of three
    (corner_a, corner_b) edges crossed by the surface."""
    cases = []
    for case in range(16):
        inside = [i for i in range(4) if case >> i & 1]
        outside = [i for i in range(4) if not case >> i & 1]
        if not inside or not outside:
            cases.append([])
        elif len(inside) == 1:
            a, = inside
            cases.append([[(a, outside[0]), (a, outside[1]),
                           (a, outside[2])]])
        elif len(outside) == 1:
            a, = outside
            cases.append([[(a, inside[0]), (a, inside[1]),
                           (a, inside[2])]])
        else:
            (i0, i1), (o0, o1) = inside, outside
            quad = [(i0, o0), (i0, o1), (i1, o1), (i1, o0)]
            cases.append([[quad[0], quad[1], quad[2]],
                          [quad[0], quad[2], quad[3]]])
    return cases


_CASES = _tet_cases()


def marching_tetrahedra(field, level, spacing=(1.0, 1.0, 1.0),
                        origin=(0.0, 0.0, 0.0)):
    """Extract the isosurface {field == level} of a (nz, ny, nx) scalar
    field.

    Returns (verts, tris): verts (V, 3) float [z, y, x] world coordinates
    (grid index * spacing + origin), tris (T, 3) int indices into verts.
    Triangles are emitted per tetrahedron (vertices are not merged across
    tets — fine for rendering; ~2x the vertex count of an indexed mesh).
    """
    f = np.asarray(field, np.float64)
    nz, ny, nx = f.shape
    cz, cy, cx = nz - 1, ny - 1, nx - 1
    if min(cz, cy, cx) < 1:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    # corner values of every cube: (ncubes, 8)
    base = np.stack(np.meshgrid(np.arange(cz), np.arange(cy),
                                np.arange(cx), indexing="ij"),
                    axis=-1).reshape(-1, 3)            # (ncubes, 3)
    corner_idx = base[:, None, :] + _CORNERS[None]     # (ncubes, 8, 3)
    vals = f[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    pos = (corner_idx * np.asarray(spacing, np.float64)
           + np.asarray(origin, np.float64))           # (ncubes, 8, 3)

    verts_out = []
    for tet in _TETS:
        tv = vals[:, tet]                              # (ncubes, 4)
        tp = pos[:, tet]                               # (ncubes, 4, 3)
        case = ((tv > level) << np.arange(4)).sum(axis=1)
        for cid in range(1, 15):
            tris = _CASES[cid]
            if not tris:
                continue
            sel = np.nonzero(case == cid)[0]
            if sel.size == 0:
                continue
            for tri in tris:
                tri_pts = np.empty((sel.size, 3, 3))
                for k, (a, b) in enumerate(tri):
                    va, vb = tv[sel, a], tv[sel, b]
                    t = (level - va) / np.where(vb == va, 1.0, vb - va)
                    t = np.clip(t, 0.0, 1.0)[:, None]
                    tri_pts[:, k] = tp[sel, a] + t * (tp[sel, b]
                                                      - tp[sel, a])
                verts_out.append(tri_pts)

    if not verts_out:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    tri_pts = np.concatenate(verts_out, axis=0)        # (T, 3, 3)
    verts = tri_pts.reshape(-1, 3)
    tris = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    return verts, tris
