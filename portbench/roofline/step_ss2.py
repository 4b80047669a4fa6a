"""One batched SS2 step's algorithm, whatever kernels implement it.

Per lane and grid point, with the Krylov basis in device memory (at the
cells' sizes it is 10-50 times the 50 MB L2) and every stage that must wait
for a global reduction a pass of its own:

  opening kick         reads u (8 bytes) and m (4), writes W_0 (8)
  Lanczos j=0..m-2     reads W_0..W_j (8 each) and the face weights, writes
                       W_{j+1} (8): the operator, the projections on every
                       column and the update in one pass
  combine, closing kick and ghost copy
                       reads the m columns and m (4), writes u (8)

and the float32 operations of the same stages."""


def per_step(s):
    m, pts = s.krylov_m, s.points
    wb = 4 * s.weight_planes
    stencil = {2: 16, 3: 24}[s.dim]
    per_pt = 20 + sum(8 * (j + 1) + wb + 8 for j in range(m - 1)) + 8 * m + 12
    flops = 13 + sum(stencil + 16 * (j + 1) + 14 for j in range(m - 1))
    flops += 8 * m + 13
    return None, per_pt * pts, flops * pts
