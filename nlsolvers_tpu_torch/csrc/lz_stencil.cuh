// The stencil operators of the hand-written Lanczos kernels, shared by
// lanczos2d.cu, lanczos3d.cu and resident2d.cu: one device function per
// operator, so that every kernel that applies an operator applies the same
// arithmetic.
//
// 2D (planar (P, ny, nx) fields):
//   OP_ISO    5-point no-flux Laplacian, "reference" (-3 on the boundary
//             ring, corners included) or "clean" (-(number of neighbours))
//             diagonal, computed from the row/column index;
//   OP_ANISO  finite-volume div(c grad u) with zero-padded face weights
//             wx, wy (ny, nx): wx zero in column nx-1, wy zero in row ny-1.
// 3D (the merged (P, R = nz*ny, nx) row view; (z, y, x) is row r = z ny + y,
// so the y neighbours are +-1 row and the z neighbours +-ny rows):
//   ISO_REF    7-point Laplacian of the reference (laplacians.hpp:105-156):
//              y neighbours are the plain merged rows, so row (z, ny-1)
//              couples to (z+1, 0) (the reference's y-seam); diagonal -5 on
//              any boundary cell, -6 inside;
//   ISO_CLEAN  y neighbours only inside a plane; diagonal -(neighbours);
//   ANISO      div(c grad u) with zero-padded face weights wx, wy, wz, each
//              (R, nx) (ops/operators.py): all boundary and seam structure is
//              in the weights.
// The operators are written on the values of a cell and its neighbours (0
// outside the grid), so a kernel may take them from global memory or from
// a ring of rebuilt values in shared memory.
//
// Shard policies (one shard's block of a grid sharded over a mesh; the
// JAX package's _stencil_shard2d*, _pass1y_shard*, _pass1zy_shard* kernels):
// the neighbours outside the block come from halo arrays (the neighbour
// shards' edges, zeros at the domain's edge): in 2D read only by the
// threads at the block's edges, in 3D copied into the frame of the shard
// kernel's plane ring (lanczos3d.cu); the iso diagonal comes from GLOBAL
// coordinates (the block's offsets); the aniso face weights are padded
// with the cross-shard faces, and the faces left of / above / below the
// block's first column, row and plane come in their own small arrays. So
// the shard operators need no masks:
//   OP_SHARD_ISO, OP_SHARD_ANISO   2D (Shard2d)
//   SHARD_REF, SHARD_CLEAN, SHARD_ANISO   3D on the merged view (Shard3d):
//     the y halo of each local z-plane carries the ay neighbour's rows
//     (clean) or, under the reference variant (z and y unsplit), the
//     merged-view seam rows, so REF and CLEAN differ only in the diagonal.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int OP_ISO = 0;      // 5-point Laplacian, diagonal from the index
constexpr int OP_ANISO = 1;    // div(c grad u) with zero-padded face weights
constexpr int OP_SHARD_ISO = 2;    // OP_ISO on one shard's block
constexpr int OP_SHARD_ANISO = 3;  // OP_ANISO on one shard's block

// What a 2D operator reads besides u: the aniso face weights (ny, nx); the
// iso diagonal variant.
struct Op2d {
  const float* wx;
  const float* wy;
  int clean;
};

// What a 2D shard operator reads besides u and its Op2d.
struct Shard2d {
  const float* yh;     // (P, 2, nx): the rows above row 0 and below ny-1
  const float* xh;     // (P, 2, ny): the columns left of 0 and right of nx-1
  const float* wxl;    // (ny) aniso: the face weights left of column 0
  const float* wyh;    // (nx) aniso: the face weights above row 0
  int y0, x0, NY, NX;  // the block's global offsets; the global grid
};

// Variant diagonal: "reference" is -3 on the whole boundary ring (corners
// included) and -4 inside; "clean" is -(number of existing neighbours).
__device__ __forceinline__ float stencil_diag(int r, int x, int ny, int nx,
                                              int clean) {
  const int top = r == 0, bot = r == ny - 1, lft = x == 0, rgt = x == nx - 1;
  if (clean) return -(4.0f - top - bot - lft - rgt);
  return (top | bot | lft | rgt) ? -3.0f : -4.0f;
}

// The operator's coefficients at cell (r, x), shared by the planes: the iso
// diagonal in k[0], or the aniso face weights at x+1/2, x-1/2, r+1/2 and
// r-1/2 (0 for a face outside the grid). The weights are never written by a
// kernel, so they go through the read-only cache.
template <int OP>
__device__ __forceinline__ void load_coef(const Op2d& op, int r, int x,
                                          int ny, int nx, size_t idx,
                                          float (&k)[4]) {
  if (OP == OP_ISO) {
    k[0] = stencil_diag(r, x, ny, nx, op.clean);
  } else {
    k[0] = __ldg(op.wx + idx);
    k[1] = x > 0 ? __ldg(op.wx + idx - 1) : 0.0f;
    k[2] = __ldg(op.wy + idx);
    k[3] = r > 0 ? __ldg(op.wy + idx - nx) : 0.0f;
  }
}

// The coefficients of a 2D shard operator at cell (r, x) of the block: the
// diagonal at the global coordinates, or the face weights with the faces
// left of column 0 and above row 0 from Shard2d.
template <int OP>
__device__ __forceinline__ void load_coef_shard(const Op2d& op,
                                                const Shard2d& sh, int r,
                                                int x, int nx, size_t idx,
                                                float (&k)[4]) {
  if (OP == OP_SHARD_ISO) {
    k[0] = stencil_diag(sh.y0 + r, sh.x0 + x, sh.NY, sh.NX, op.clean);
  } else {
    k[0] = __ldg(op.wx + idx);
    k[1] = x > 0 ? __ldg(op.wx + idx - 1) : __ldg(sh.wxl + r);
    k[2] = __ldg(op.wy + idx);
    k[3] = r > 0 ? __ldg(op.wy + idx - nx) : __ldg(sh.wyh + x);
  }
}

// The four neighbours of cell (r, x) of plane p of a shard's block b: from
// the block inside it, from the halos at its edges.
__device__ __forceinline__ void neighbours_shard2d(
    const float* __restrict__ b, const Shard2d& sh, int p, size_t idx, int r,
    int x, int ny, int nx, float& up, float& dn, float& lf, float& rt) {
  up = r > 0 ? __ldg(b + idx - nx) : __ldg(sh.yh + (size_t)2 * p * nx + x);
  dn = r < ny - 1 ? __ldg(b + idx + nx)
                  : __ldg(sh.yh + (size_t)(2 * p + 1) * nx + x);
  lf = x > 0 ? __ldg(b + idx - 1) : __ldg(sh.xh + (size_t)2 * p * ny + r);
  rt = x < nx - 1 ? __ldg(b + idx + 1)
                  : __ldg(sh.xh + (size_t)(2 * p + 1) * ny + r);
}

// A(u) at one 2D cell before the scale, from the cell c and its neighbours
// (0 outside the grid). aniso keeps _stencil_aniso's order of terms:
// fx - fx[x-1] + fy - fy[r-1], with no face left of x = 0 or above r = 0
// (on a shard those faces are in k, 0 at the domain's edge).
template <int OP>
__device__ __forceinline__ float stencil(float c, float up, float dn,
                                         float lf, float rt, int r, int x,
                                         const float (&k)[4]) {
  if (OP == OP_ISO || OP == OP_SHARD_ISO) return up + dn + lf + rt + k[0] * c;
  const bool shard = OP == OP_SHARD_ANISO;
  const float fx = k[0] * (rt - c);
  const float fx_l = shard || x > 0 ? k[1] * (c - lf) : 0.0f;
  const float fy = k[2] * (dn - c);
  const float fy_u = shard || r > 0 ? k[3] * (c - up) : 0.0f;
  return fx - fx_l + fy - fy_u;
}

enum Mode {
  ISO_REF = 0, ISO_CLEAN = 1, ANISO = 2,
  SHARD_REF = 3, SHARD_CLEAN = 4, SHARD_ANISO = 5   // on one shard's block
};

struct Weights { const float* wx; const float* wy; const float* wz; };

// What a 3D shard operator reads besides u and its Weights (the block is
// (nz, ny, nx), merged view R = nz ny).
struct Shard3d {
  const float* yh;     // (P, 2, nz, nx): each plane's rows above y = 0 and
                       // below y = ny-1
  const float* zh;     // (P, 2, ny, nx): the planes below z = 0, above nz-1
  const float* xh;     // (P, 2, R): the columns left of 0 and right of nx-1
  const float* wxl;    // (R) aniso: the face weights left of column 0
  const float* wyh;    // (nz, nx) aniso: the face weights above each y = 0
  const float* wzh;    // (ny, nx) aniso: the face weights below z = 0
  int z0, y0, x0, NZ, NY, NX;  // the block's global offsets; the grid
};

// The 3D operator at merged row r = z ny + y, column x, scaled by ss, from
// the cell cv and its neighbours on the merged view: up/dn the rows r-1 and
// r+1, zu/zd the rows r-ny and r+ny, lf/rt the columns x-1 and x+1, each 0
// where that row or column lies outside the view. ISO_CLEAN drops the
// neighbours across the y-seam itself; ANISO reads its face weights at idx
// (idx - 1, idx - nx and idx - ny nx for the lower faces).
template <int MODE>
__device__ __forceinline__ float stencil3d_vals(float cv, float up, float dn,
                                                float zu, float zd, float lf,
                                                float rt, const Weights& wt,
                                                size_t idx, int r, int z,
                                                int y, int x, int nz, int ny,
                                                int nx, float ss) {
  if (MODE == ANISO) {
    const size_t zoff = (size_t)ny * nx;
    const float fx = __ldg(wt.wx + idx) * (rt - cv);
    const float fx_l = x > 0 ? __ldg(wt.wx + idx - 1) * (cv - lf) : 0.0f;
    const float fy = __ldg(wt.wy + idx) * (dn - cv);
    const float fy_m1 = r > 0 ? __ldg(wt.wy + idx - nx) * (cv - up) : 0.0f;
    const float fz = __ldg(wt.wz + idx) * (zd - cv);
    const float fz_m = z > 0 ? __ldg(wt.wz + idx - zoff) * (cv - zu) : 0.0f;
    return (fx - fx_l + fy - fy_m1 + fz - fz_m) * ss;
  }
  if (MODE == ISO_CLEAN) {
    if (y == 0) up = 0.0f;
    if (y == ny - 1) dn = 0.0f;
  }
  const int zb0 = z == 0, zb1 = z == nz - 1, yb0 = y == 0, yb1 = y == ny - 1;
  const int xb0 = x == 0, xb1 = x == nx - 1;
  float diag;
  if (MODE == ISO_REF)
    diag = (zb0 | zb1 | yb0 | yb1 | xb0 | xb1) ? -5.0f : -6.0f;
  else
    diag = -(6.0f - (float)(zb0 + zb1 + yb0 + yb1 + xb0 + xb1));
  return (up + dn + zu + zd + lf + rt + diag * cv) * ss;
}

// Loads for the operators: through the read-only cache for a field that no
// block writes during the launch, or from L2 (bypassing L1) for one that
// other blocks of the same cooperative launch wrote before a grid sync.
struct LdNC {
  __device__ static __forceinline__ float ld(const float* p) {
    return __ldg(p);
  }
  __device__ static __forceinline__ float4 ld4(const float4* p) {
    return __ldg(p);
  }
};
struct LdL2 {
  __device__ static __forceinline__ float ld(const float* p) {
    return __ldcg(p);
  }
  __device__ static __forceinline__ float4 ld4(const float4* p) {
    return __ldcg(p);
  }
};

// The 3D operator on one plane b of a field in global memory.
template <int MODE, class LD = LdNC>
__device__ __forceinline__ float stencil3d(const float* b, const Weights& wt,
                                           size_t idx, int r, int z, int y,
                                           int x, int R, int nz, int ny,
                                           int nx, float ss) {
  const size_t zoff = (size_t)ny * nx;
  const float cv = LD::ld(b + idx);
  const float up = r > 0 ? LD::ld(b + idx - nx) : 0.0f;
  const float dn = r < R - 1 ? LD::ld(b + idx + nx) : 0.0f;
  const float zu = z > 0 ? LD::ld(b + idx - zoff) : 0.0f;
  const float zd = z < nz - 1 ? LD::ld(b + idx + zoff) : 0.0f;
  const float lf = x > 0 ? LD::ld(b + idx - 1) : 0.0f;
  const float rt = x < nx - 1 ? LD::ld(b + idx + 1) : 0.0f;
  return stencil3d_vals<MODE>(cv, up, dn, zu, zd, lf, rt, wt, idx, r, z, y,
                              x, nz, ny, nx, ss);
}

// The 2D operator on one plane b of a field in global memory, scaled by ss.
template <int OP, class LD = LdNC>
__device__ __forceinline__ float stencil2d(const float* b, const Op2d& op,
                                           size_t idx, int r, int x, int ny,
                                           int nx, float ss) {
  float k[4];
  load_coef<OP>(op, r, x, ny, nx, idx, k);
  const float cv = LD::ld(b + idx);
  const float up = r > 0 ? LD::ld(b + idx - nx) : 0.0f;
  const float dn = r < ny - 1 ? LD::ld(b + idx + nx) : 0.0f;
  const float lf = x > 0 ? LD::ld(b + idx - 1) : 0.0f;
  const float rt = x < nx - 1 ? LD::ld(b + idx + 1) : 0.0f;
  return stencil<OP>(cv, up, dn, lf, rt, r, x, k) * ss;
}

}  // namespace
