"""Matrix-free no-flux Laplacians in 2D and 3D.

Port of nlsolvers_tpu/ops/operators.py.

`laplacian_2d` reproduces the reference's `build_laplacian_noflux`
(laplacians.hpp:10-52): diagonal -4 inside and -3 on the whole boundary ring,
corners included (`variant="reference"`), or -(number of neighbours)
(`variant="clean"`).

`laplacian_3d` reproduces `build_laplacian_noflux_3d` (laplacians.hpp:
105-156) with its y-seam: the y-neighbour loop couples flat indices i and
i + (nx+2) for all i, which links the last y-row of each z-plane to the first
y-row of the next. It is expressed exactly by taking the y-neighbour sum over
the merged (nz*ny, nx) view. `variant="clean"` drops the seam and uses
diagonal -(number of neighbours).

`anisotropic_laplacian_2d` and `anisotropic_laplacian_3d` reproduce the
finite-volume div(c grad u) builders (laplacians.hpp:54-103, 158-218): face
coupling = mean of the two cells' c, diagonal = minus the sum of the row's
couplings, with the 3D y-seam under `variant="reference"`.

`separated_laplacian_2d` reproduces `build_separated_laplacian_noflux`
(laplacians.hpp:220-269): per-direction 1D operators whose sum is the 2D
5-point operator, corner quirk included.

Operators are closures `apply(u) -> Lu` on fields shaped (..., ny, nx) or
(..., nz, ny, nx); leading axes are batch axes. Each stencil operator
carries `kernel_desc`, the descriptor the Krylov dispatch reads
(ops/krylov._fused_path -> ops/cuda/lanczos2d, lanczos3d); the separated
pair has none and always takes the generic path. The operators and their
tensors live on `device`, the card unless the caller asks for the CPU.

`biharmonic_x` reproduces `build_xxxx_noflux` (root laplacians.hpp:
158-200), the fourth x-derivative of the Boussinesq operator, with the
reference's one-sided rows at both ends; it carries no descriptor.
"""

import numpy as np
import torch

__all__ = ["laplacian_2d", "laplacian_3d", "anisotropic_laplacian_2d",
           "batched_aniso_laplacian_2d",
           "anisotropic_laplacian_3d", "batched_aniso_laplacian_3d",
           "separated_laplacian_2d",
           "biharmonic_x", "neighbor_sum", "block_coords", "boundary_diagonal"]


def neighbor_sum(u, dim):
    """Sum of the existing (non-wrapping) neighbours along one dimension:
    cell i receives u[i-1] + u[i+1] where those exist, 0 otherwise."""
    n = u.shape[dim]
    z = torch.zeros_like(u.narrow(dim, 0, 1))
    fwd = torch.cat([u.narrow(dim, 1, n - 1), z], dim=dim)
    bwd = torch.cat([z, u.narrow(dim, 0, n - 1)], dim=dim)
    return fwd + bwd


def block_coords(offsets, shape, device):
    """Global index tensors of a block `shape` at `offsets` of a larger
    grid, one per axis, each broadcastable to the block."""
    nd = len(shape)
    return [o + torch.arange(n, device=device).reshape(
        [n if a == d else 1 for a in range(nd)])
        for d, (o, n) in enumerate(zip(offsets, shape))]


def boundary_diagonal(coords, dims, variant, dtype):
    """The variant diagonal of the no-flux Laplacian at the global
    coordinates `coords` (one index tensor per axis, broadcastable) of a
    grid of `dims`, in 2D or 3D: "reference" is -(2d-1) on any boundary cell
    and -2d inside, "clean" is -(number of neighbours). The sharded
    operators build their diagonal with it."""
    bounds = [b for c, n in zip(coords, dims) for b in (c == 0, c == n - 1)]
    if variant == "reference":
        anyb = bounds[0]
        for b in bounds[1:]:
            anyb = anyb | b
        n2 = 2.0 * len(dims)
        return torch.where(anyb, 1.0 - n2, -n2).to(dtype)
    if variant != "clean":
        raise ValueError(f"unknown variant {variant!r}")
    nnb = 2.0 * len(dims)
    for b in bounds:
        nnb = nnb - b.to(dtype)
    return -nnb


def _diagonal_2d(ny, nx, variant):
    ring = torch.zeros((ny, nx), dtype=torch.float64)
    ring[0, :] = ring[-1, :] = 1.0
    ring[:, 0] = ring[:, -1] = 1.0
    if variant == "reference":
        return -4.0 + ring
    if variant == "clean":
        cnt = torch.full((ny, nx), 4.0, dtype=torch.float64)
        cnt[0, :] -= 1.0
        cnt[-1, :] -= 1.0
        cnt[:, 0] -= 1.0
        cnt[:, -1] -= 1.0
        return -cnt
    raise ValueError(f"unknown variant {variant!r}")


def _boundary_mask_3d(nz, ny, nx):
    m = torch.zeros((nz, ny, nx), dtype=torch.float64)
    m[0], m[-1] = 1.0, 1.0
    m[:, 0, :] = m[:, -1, :] = 1.0
    m[:, :, 0] = m[:, :, -1] = 1.0
    return m


def _neighbor_count_3d(nz, ny, nx):
    c = torch.full((nz, ny, nx), 6.0, dtype=torch.float64)
    for dim, n in ((0, nz), (1, ny), (2, nx)):
        c.select(dim, 0).sub_(1.0)
        c.select(dim, n - 1).sub_(1.0)
    return c


def laplacian_2d(shape, dx, dy, variant="reference", dtype=torch.float32,
                 device="cuda"):
    """Matrix-free 5-point no-flux Laplacian on an (ny, nx) grid."""
    ny, nx = shape
    diag = _diagonal_2d(ny, nx, variant).to(device=device, dtype=dtype)
    scale = 1.0 / (dx * dy)

    def apply(u):
        nb = neighbor_sum(u, -1) + neighbor_sum(u, -2)
        return (nb + diag * u) * scale

    apply.kernel_desc = dict(kind="laplacian_2d", ny=int(ny), nx=int(nx),
                             scale=float(scale), sign=1.0, variant=variant)
    return apply


def laplacian_3d(shape, dx, variant="reference", dtype=torch.float32,
                 device="cuda"):
    """Matrix-free 7-point no-flux Laplacian on an (nz, ny, nx) grid, scaled
    1/dx^2, with the reference's y-seam under variant="reference"."""
    nz, ny, nx = shape
    if variant == "reference":
        diag = -6.0 + _boundary_mask_3d(nz, ny, nx)  # -5 anywhere on boundary
    elif variant == "clean":
        diag = -_neighbor_count_3d(nz, ny, nx)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    diag = diag.to(device=device, dtype=dtype)
    scale = 1.0 / (dx * dx)

    def apply(u):
        batch = u.shape[:-3]
        nb = neighbor_sum(u, -1) + neighbor_sum(u, -3)
        if variant == "reference":
            v = u.reshape(batch + (nz * ny, nx))
            nb = nb + neighbor_sum(v, -2).reshape(u.shape)
        else:
            nb = nb + neighbor_sum(u, -2)
        return (nb + diag * u) * scale

    apply.kernel_desc = dict(kind="laplacian_3d", nz=int(nz), ny=int(ny),
                             nx=int(nx), scale=float(scale), sign=1.0,
                             variant=variant)
    return apply


def anisotropic_laplacian_2d(c, dx, dy, device="cuda"):
    """Finite-volume div(c grad u) on an (ny, nx) grid, scaled 1/(dx*dy).

    `c` (numpy or tensor, (ny, nx)) keeps its dtype for `apply`. The
    descriptor carries the face weights zero-padded to (ny, nx) as float32
    tensors on `device`: wx pads column nx-1, wy row ny-1 (the no-flux
    faces).
    """
    if not isinstance(c, torch.Tensor):
        c = torch.from_numpy(np.array(c))
    c = c.to(device)
    ny, nx = c.shape
    wx = 0.5 * (c[:, :-1] + c[:, 1:])                 # faces along x
    wy = 0.5 * (c[:-1, :] + c[1:, :])                 # faces along y
    scale = 1.0 / (dx * dy)

    def apply(u):
        fx = wx * (u[..., :, 1:] - u[..., :, :-1])
        fy = wy * (u[..., 1:, :] - u[..., :-1, :])
        out = torch.zeros(u.shape[:-2] + (ny, nx),
                          dtype=torch.result_type(u, wx), device=u.device)
        out[..., :, :-1] += fx
        out[..., :, 1:] -= fx
        out[..., :-1, :] += fy
        out[..., 1:, :] -= fy
        return out * scale

    f32 = dict(dtype=torch.float32, device=c.device)
    wx_pad = torch.zeros((ny, nx), **f32)
    wx_pad[:, :nx - 1] = wx
    wy_pad = torch.zeros((ny, nx), **f32)
    wy_pad[:ny - 1] = wy
    apply.kernel_desc = dict(kind="aniso_laplacian_2d", ny=int(ny),
                             nx=int(nx), scale=float(scale), sign=1.0,
                             variant="aniso", wx=wx_pad, wy=wy_pad)
    return apply


def batched_aniso_laplacian_2d(cs, dx, dy, device="cuda"):
    """The kernel descriptor of div(c grad u) for a batch of B lanes, each
    with its own c: the descriptor of anisotropic_laplacian_2d(cs[b], dx,
    dy) per lane, built once per batch, with the face weights stacked to
    (B, ny, nx) float32 (lane b's bits are its own operator's). The fused
    kernels take it with a (B, P, ny, nx) batch of fields."""
    descs = [anisotropic_laplacian_2d(c, dx, dy, device=device).kernel_desc
             for c in cs]
    return dict(descs[0], wx=torch.stack([d["wx"] for d in descs]),
                wy=torch.stack([d["wy"] for d in descs]))


def separated_laplacian_2d(shape, dx, dy, dtype=torch.float32,
                           device="cuda"):
    """Per-direction 1D no-flux Laplacians (Lx, Ly) on an (ny, nx) grid.

    Diagonals: -2 inside, -1 on that direction's boundary, -1.5 at the
    corners. Returns (apply_x, apply_y); apply_x(u) + apply_y(u) is the 2D
    reference-variant operator. No descriptor: the generic Krylov path.
    """
    ny, nx = shape
    col = torch.arange(nx)[None, :].expand(ny, nx)
    row = torch.arange(ny)[:, None].expand(ny, nx)
    x_edge = (col == 0) | (col == nx - 1)
    y_edge = (row == 0) | (row == ny - 1)
    corner = x_edge & y_edge
    diag_x = torch.where(x_edge, -1.0, -2.0).to(torch.float64)
    diag_x[corner] = -1.5
    diag_y = torch.where(y_edge, -1.0, -2.0).to(torch.float64)
    diag_y[corner] = -1.5
    diag_x = diag_x.to(device=device, dtype=dtype)
    diag_y = diag_y.to(device=device, dtype=dtype)

    def apply_x(u):
        return (neighbor_sum(u, -1) + diag_x * u) / (dx * dx)

    def apply_y(u):
        return (neighbor_sum(u, -2) + diag_y * u) / (dy * dy)

    return apply_x, apply_y


def anisotropic_laplacian_3d(c, dx, variant="reference", device="cuda"):
    """Finite-volume div(c grad u) on an (nz, ny, nx) grid, scaled 1/dx^2.

    `c` (numpy or tensor, (nz, ny, nx)) keeps its dtype for `apply`. The
    descriptor carries the face weights zero-padded to the merged
    (nz*ny, nx) row view as float32 tensors on `device`: wx pads column
    nx-1, wy the rows without a +y face (the last merged row under
    "reference", whose other rows are the y-seam couplings; each plane's
    last row under "clean"), wz the last plane.
    """
    if not isinstance(c, torch.Tensor):
        c = torch.from_numpy(np.array(c))
    c = c.to(device)
    nz, ny, nx = c.shape
    R = nz * ny
    scale = 1.0 / (dx * dx)
    cm = c.reshape(R, nx)
    wx = 0.5 * (c[:, :, :-1] + c[:, :, 1:])
    wz = 0.5 * (c[:-1] + c[1:])
    if variant == "reference":
        wy = 0.5 * (cm[:-1] + cm[1:])                 # merged rows
    elif variant == "clean":
        wy = 0.5 * (c[:, :-1, :] + c[:, 1:, :])
    else:
        raise ValueError(f"unknown variant {variant!r}")

    def apply(u):
        out = torch.zeros(u.shape[:-3] + (nz, ny, nx),
                          dtype=torch.result_type(u, wx), device=u.device)
        fx = wx * (u[..., :, :, 1:] - u[..., :, :, :-1])
        out[..., :, :, :-1] += fx
        out[..., :, :, 1:] -= fx
        fz = wz * (u[..., 1:, :, :] - u[..., :-1, :, :])
        out[..., :-1, :, :] += fz
        out[..., 1:, :, :] -= fz
        if variant == "reference":
            um = u.reshape(u.shape[:-3] + (R, nx))
            om = out.view(out.shape[:-3] + (R, nx))
            fy = wy * (um[..., 1:, :] - um[..., :-1, :])
            om[..., :-1, :] += fy
            om[..., 1:, :] -= fy
        else:
            fy = wy * (u[..., :, 1:, :] - u[..., :, :-1, :])
            out[..., :, :-1, :] += fy
            out[..., :, 1:, :] -= fy
        return out * scale

    f32 = dict(dtype=torch.float32, device=c.device)
    wx_pad = torch.zeros((R, nx), **f32)
    wx_pad[:, :nx - 1] = wx.reshape(R, nx - 1)
    wy_pad = torch.zeros((R, nx), **f32)
    if variant == "reference":
        wy_pad[:R - 1] = wy
    else:
        wy_pad.view(nz, ny, nx)[:, :ny - 1] = wy
    wz_pad = torch.zeros((R, nx), **f32)
    wz_pad[:R - ny] = wz.reshape(R - ny, nx)
    apply.kernel_desc = dict(kind="aniso_laplacian_3d", nz=int(nz),
                             ny=int(ny), nx=int(nx), scale=float(scale),
                             sign=1.0, variant="aniso", wx=wx_pad, wy=wy_pad,
                             wz=wz_pad)
    return apply


def batched_aniso_laplacian_3d(cs, dx, variant="reference", device="cuda"):
    """The kernel descriptor of div(c grad u) on an (nz, ny, nx) grid for a
    batch of B lanes, each with its own c: the descriptor of
    anisotropic_laplacian_3d(cs[b], dx, variant) per lane, built once per
    batch, with the face weights stacked to (B, nz*ny, nx) float32 (lane
    b's bits are its own operator's). The fused kernels take it with a
    (B, P, nz*ny, nx) batch of fields."""
    descs = [anisotropic_laplacian_3d(c, dx, variant=variant,
                                      device=device).kernel_desc for c in cs]
    return dict(descs[0], **{k: torch.stack([d[k] for d in descs])
                             for k in ("wx", "wy", "wz")})


def _biharmonic_coefs(nx):
    """{k: per-column coefficient of u[i+k] in row i} of biharmonic_x."""
    interior = (np.arange(nx) >= 2) & (np.arange(nx) <= nx - 3)
    coefs = {}
    for k, inner in ((-2, 1.0), (-1, -4.0), (0, 6.0), (1, -4.0), (2, 1.0)):
        c = np.zeros(nx)
        c[interior] = inner
        coefs[k] = c
    coefs[0][[0, nx - 1]] = 2.0
    coefs[0][[1, nx - 2]] = 4.0
    coefs[1][[0, 1]] = -2.0         # rows 0 and 1 touch u1 and u2
    coefs[2][1] = -2.0              # row 1 touches u3
    coefs[-1][[nx - 1, nx - 2]] = -2.0
    coefs[-2][nx - 2] = -2.0        # row nx-2 touches u[-4]
    return coefs


def biharmonic_x(shape, dx, dtype=torch.float32, device="cuda"):
    """1D fourth derivative along x on an (ny, nx) grid, scaled 1/dx^4, with
    the reference's closures (per x-index i):
      i = 0      :  2 u0 - 2 u1
      i = nx-1   :  2 u[-1] - 2 u[-2]
      i = 1      :  4 u1 - 2 u2 - 2 u3
      i = nx-2   :  4 u[-2] - 2 u[-3] - 2 u[-4]
      interior   :  u[i-2] - 4 u[i-1] + 6 u[i] - 4 u[i+1] + u[i+2]
    as masked shifts, summed in the order k = -2..2."""
    _, nx = shape
    scale = 1.0 / dx ** 4
    coefs = {k: torch.from_numpy(c).to(device=device, dtype=dtype)
             for k, c in _biharmonic_coefs(nx).items()}

    def shift(u, k):
        """u[i+k] along the last axis, zero where out of range."""
        if k == 0:
            return u
        pad = torch.zeros(u.shape[:-1] + (abs(k),), dtype=u.dtype,
                          device=u.device)
        if k > 0:
            return torch.cat([u[..., k:], pad], dim=-1)
        return torch.cat([pad, u[..., :k]], dim=-1)

    def apply(u):
        out = torch.zeros_like(u)
        for k, c in coefs.items():
            out = out + c * shift(u, k)
        return out * scale

    return apply
