// The fused Lanczos iteration (K5, lanczos2d.cu iter_kernel) and the first
// phase it shares with K1 / K1' (lanczos2d.cu pass1_tile_kernel), both on
// lz_tile.cuh's tile walker; and the grid-wide pieces (reduce_all,
// coop_launch) that the resident SS2 step (K13, resident2d.cu) shares.
//
// One iteration j of the normalized two-pass loop (classical Gram-Schmidt
// with full reorthogonalization, the JAX package's _iter_call):
//   phase 0 (wpass)    w = s_j A(W_j) - bs W_{j-1}, and the block's partial
//                      sums of raw_i = <W_i, w>, i <= j (alone, this is
//                      K1: the JAX package's _pass1_call, which also sums
//                      ||W_j||^2);
//   grid sync; every block sums the partials (reduce_all);
//   phase 1 (subpass)  W_{j+1} = w - sum_i q_i W_i with q_i = s_i^2 raw_i,
//                      and the block's partial sum of ||W_{j+1}||^2.
//
// Geometry. The field (P, rows, nx) is cut into strips of PX = 128 columns;
// a segment is one row of one strip, numbered strip-major (segment
// strip * rows + row). Block b of a grid of G owns the segments
// [b S / G, (b + 1) S / G) of all S: at most ceil(S / G) rows, in one strip
// or a few, and the same ones in both phases. 3D fields are the merged
// (nz ny, nx) view, whose z neighbours lie ny rows away.
//
// wpass walks each strip's run of the block's rows (a tile) as K2 does:
// warp w loads row k = PWARP st + w of the tile's rows and its two halo rows
// (16-byte loads; lanes 0 and 31 the halo columns) into a shared ring of
// RING rows; one barrier per step; then warp w stencils tile row k - 2 from
// the ring, its side neighbours by warp shuffles (3D: the z neighbours from
// global memory, where the neighbouring blocks' walk has just brought them
// into L2), forms w = s av - bs W_{j-1} and takes the dots: raw_j from the
// ring, raw_i (i < j) from lz_tile.cuh's lane-group dots (tile_dots: W_i
// from global memory, w from shared memory). A warp holds the W_j rows of
// its next two steps in registers, so that their loads' latency hides
// behind the steps between.
//
// Where w goes. K5 keeps the block's w rows in dynamic shared memory where
// they fit (the on-chip form): phase 1 reads them back after the grid sync,
// and no w reaches device memory. A field whose w does not fit on the card
// (lanczos2d.py's iter_plan decides, by size) writes w to a global scratch
// and reads it back through L2 (the global form), as K1 writes w, its
// output. Neither form stands in for the other when a launch fails.
//
// Phase 1 walks the block's segments in the reverse order of phase 0, one
// row per warp: the basis rows that phase 0 read last are then still in
// the 50 MB L2 when phase 1 reads them first.
//
// A batch of lanes is one K5 launch on one lane's grid (lanczos2d.cu
// iter_kernel): each block runs wpass on its segments of every lane, then
// after the grid sync subpass on every lane, each lane with partial-sum
// rows of its own, so each lane sums in the order of its launch alone.
//
// Cross-block sums are deterministic and need no atomics: each block writes
// its partial sums, one row per output (partial[o * gridDim.x + block]), and
// after the grid sync EVERY block sums all rows in the same fixed order, so
// every block holds the same bits of every scalar and computes the same
// coefficients from them; K1 reduces its rows with reduce_partials_om.

#pragma once

#include <cooperative_groups.h>

#include "lz_common.cuh"
#include "lz_stencil.cuh"
#include "lz_tile.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int COOP_PER_SM = 2;      // most blocks per SM a K5 launch uses

// Blocks per SM the K5 and K1 instantiations are compiled for: two (128
// registers), but one for the forms that would spill at two (K5: the
// 16-byte forms with dots of 32 columns, or 16 of a real field, and since
// its lane loop the scalar forms of a complex field; K1: the 16-byte forms
// with 16 or 32 columns of a real field). MAXW: the bucket of j.
template <int P, int MAXW, int VEC>
constexpr int ITER_PER_SM =
    (VEC == 4 && (MAXW == 32 || (P == 1 && MAXW == 16)))
            || (VEC == 1 && P == 2) ? 1 : 2;
template <int P, int MAXW, int VEC>
constexpr int PASS1_PER_SM = VEC == 4 && P == 1 && MAXW >= 16 ? 1 : 2;

// The operators of the fused iteration and of K1 / K1'.
constexpr int OPK_ISO2D = 0;        // 5-point Laplacian (variant in op2.clean)
constexpr int OPK_ANISO2D = 1;      // div(c grad u), face weights in op2
constexpr int OPK_ISO3D_REF = 2;    // 7-point Laplacian with the y-seam
constexpr int OPK_ISO3D_CLEAN = 3;  // 7-point Laplacian without it

struct OpArgs {
  Op2d op2;          // 2D operators' weights or variant
  int nz, ny, nx;    // the grid; 2D has nz = 1, rows = nz * ny
  float ss;          // scale * sign
};

// After a grid sync, in every block of NW warps: out[o] = sum_b
// partial[o][b], o < nout, in one fixed order (lane l adds b = l, l + 32,
// ..., then the warp's shuffle tree), so every block gets the same bits.
// out is shared memory.
template <int NW>
__device__ __forceinline__ void reduce_all(const float* partial, int nout,
                                           float* out) {
  const int lane = threadIdx.x & 31;
  const int nblk = (int)gridDim.x;
  for (int o = threadIdx.x >> 5; o < nout; o += NW) {
    float acc = 0.0f;
    for (int b = lane; b < nblk; b += 32)
      acc += __ldcg(partial + (size_t)o * nblk + b);
    acc = warp_sum(acc);
    if (lane == 0) out[o] = acc;
  }
  __syncthreads();
}

// Segments (rows of PX-column strips) of a (rows, nx) field.
__host__ __device__ __forceinline__ int num_segs(int rows, int nx) {
  return (nx + PX - 1) / PX * rows;
}

// The block's segments [s0, s1) of nseg, split evenly over the grid.
__device__ __forceinline__ void block_segs(int nseg, int& s0, int& s1) {
  s0 = (int)((long long)blockIdx.x * nseg / gridDim.x);
  s1 = (int)((long long)(blockIdx.x + 1) * nseg / gridDim.x);
}

// The block's sums red[warp][o], o < nout, into partial[o * gridDim.x +
// block], summed over the warps in a fixed order.
__device__ __forceinline__ void block_partials(float (*red)[RED_W], int nout,
                                               float* __restrict__ partial) {
  __syncthreads();
  for (int o = threadIdx.x; o < nout; o += PT) {
    float v = red[0][o];
#pragma unroll
    for (int ww = 1; ww < PWARP; ++ww) v += red[ww][o];
    partial[(size_t)o * gridDim.x + blockIdx.x] = v;
  }
}

// Tile row k - 1 of W_j (row r0 - 1 + k of the field, 0 outside it) at a
// lane's four points of the strip at x0 and, in lanes 0 and 31, the halo
// column left of / right of the strip (0 outside the field).
template <int P, int VEC>
__device__ __forceinline__ void wj_row(const float* __restrict__ wj, int k,
                                       int r0, int rows, int nx, int x0,
                                       int nv, size_t plane, int lane,
                                       float (&v)[P][4], float (&h)[P]) {
  const int r = r0 - 1 + k;
  const long hoff = lane == 0 ? -1 : PX;
  const bool hin = (lane == 0 || lane == 31) && x0 + hoff >= 0
                   && x0 + hoff < nx;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (r >= 0 && r < rows) {
      const float* b = wj + p * plane + (size_t)r * nx + x0;
      ldv<VEC>(b, lane, nv, v[p]);
      h[p] = hin ? __ldg(b + hoff) : 0.0f;
    } else {
      v[p][0] = v[p][1] = v[p][2] = v[p][3] = 0.0f;
      h[p] = 0.0f;
    }
  }
}

// The block's raw sums, i <= j, into partial (rows 2i (re), 2i + 1 (im)):
// i < j from the lane-group sums g (tile_dots), i = j from the lane sums dl;
// with NSQ also ||W_j||^2 from the lane sums nj, into row 2j + 2.
template <int MAXW, bool NSQ>
__device__ __forceinline__ void raw_partials(
    const float (&g)[4][2], const float (&dl)[2], float nj, int j, int lane,
    int w, int q, int gl, float (*red)[RED_W], float* __restrict__ partial) {
  constexpr int NG = MAXW / 4;
  constexpr int L = 32 / NG;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int i = q + NG * c;
    const float g0 = group_sum<L>(g[c][0]), g1 = group_sum<L>(g[c][1]);
    if (gl == 0 && i < j) {
      red[w][2 * i] = g0;
      red[w][2 * i + 1] = g1;
    }
  }
  const float d0 = warp_sum(dl[0]), d1 = warp_sum(dl[1]);
  if (lane == 0) {
    red[w][2 * j] = d0;
    red[w][2 * j + 1] = d1;
  }
  if (NSQ) {
    nj = warp_sum(nj);
    if (lane == 0) red[w][2 * j + 2] = nj;
  }
  block_partials(red, 2 * (j + 1) + NSQ, partial);
}

// wpass's inputs of one lane (K1: the lane of blockIdx.y; K5: the lane of
// its lane loop): W_j, where w goes (the block's on-chip rows wsm, or null;
// the global rows wg, or null), the block's partial-sum rows, the lane's
// face weights (aniso2d) and the scalars s_j, bs. K5 keeps them in shared
// memory: wpass reads them where it uses them, after the walk's barriers,
// so that they hold no register across the walk.
struct WLane {
  const float* wj;
  float* wsm;
  float* wg;
  float* partial;
  const float* wx;
  const float* wy;
  float s, bs;
};

// Phase 0 over the block's segments [s0, s1) (see the top of the file): w
// into L.wsm (shared, row k = segment s0 + k, P planes of PX floats) or, if
// that is null, into the field L.wg through the per-warp shared rows wrow
// (P planes of PX floats per warp); the block's raw sums to L.partial
// (raw_partials). wp: W_0..W_{j-1} in shared memory. ring: RING rows, hal:
// RING rows, red: PWARP rows of RED_W. lane, w: the thread's lane and warp;
// q, gl: its dot group (of 32 / (MAXW / 4) lanes) and its lane in the
// group. MAXW bounds j. NSQ (K1 / K1'): ||W_j||^2 as one more sum, from the
// ring's centre rows. a.op2's face weights are L's.
template <int P, int MAXW, int OPK, int VEC, bool NSQ = false>
__device__ __forceinline__ void wpass(
    const WLane& L, const float* const* wp, int j, const OpArgs& a, int s0,
    int s1, float* wrow, float (*ring)[P][PX], float (*hal)[P][2],
    float (*red)[RED_W], int lane, int w, int q, int gl) {
  constexpr bool TWO_D = OPK == OPK_ISO2D || OPK == OPK_ANISO2D;
  constexpr int OP = OPK == OPK_ANISO2D ? OP_ANISO : OP_ISO;
  constexpr int MODE = OPK == OPK_ISO3D_REF ? ISO_REF : ISO_CLEAN;
  const int nx = a.nx, rows = a.nz * a.ny;
  const size_t plane = (size_t)rows * nx;
  const size_t zoff = (size_t)a.ny * nx;
  const float* __restrict__ wjm1 = j > 0 ? wp[j - 1] : nullptr;
  float g[4][2] = {}, d[4][2] = {};
  float dl[2] = {0.0f, 0.0f};        // raw_j = <W_j, w>
  float nj = 0.0f;                    // ||W_j||^2 (NSQ)

  for (int sg = s0; sg < s1;) {
    const int strip = sg / rows, r0 = sg - strip * rows;
    const int h = min(rows - r0, s1 - sg);        // the tile's rows
    const int x0 = strip * PX, nv = nx - x0;
    const int steps = (h + 2 + PWARP - 1) / PWARP;
    float* const wsm = L.wsm;
    float* const wt = wsm == nullptr ? nullptr
                                     : wsm + (size_t)(sg - s0) * P * PX;
    float va[P][4], ha[P], vb[P][4], hb[P];       // rows k and k + PWARP
    if (w < h + 2)
      wj_row<P, VEC>(L.wj, w, r0, rows, nx, x0, nv, plane, lane, va, ha);
    if (w + PWARP < h + 2)
      wj_row<P, VEC>(L.wj, w + PWARP, r0, rows, nx, x0, nv, plane, lane, vb,
                     hb);
    for (int st = 0; st < steps; ++st) {
      const int k = PWARP * st + w;               // ring row: tile row k - 1
      if (k < h + 2) {
        const int slot = k % RING;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          sts<VEC>(ring[slot][p], lane, va[p]);
          if (lane == 0) hal[slot][p][0] = ha[p];
          if (lane == 31) hal[slot][p][1] = ha[p];
        }
      }
      __syncthreads();
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int e = 0; e < 4; ++e) va[p][e] = vb[p][e];
        ha[p] = hb[p];
      }
      if (k + 2 * PWARP < h + 2)                  // two steps ahead
        wj_row<P, VEC>(L.wj, k + 2 * PWARP, r0, rows, nx, x0, nv, plane,
                       lane, vb, hb);
      const int t = k - 2;                        // stencilled tile row
      if (t >= 0 && t < h) {
        const int r = r0 + t;
        const size_t base = (size_t)r * nx + x0;
        const int sc = (t + 1) % RING, su = t % RING, sd = (t + 2) % RING;
        float kf[4][4];
        int z = 0, y = 0;
        if constexpr (TWO_D) {
          const Op2d op2 = {L.wx, L.wy, a.op2.clean};
          coef_row<OP, VEC>(op2, r, x0, a.ny, nx, base, nv, lane, kf);
        } else {
          z = r / a.ny;
          y = r - z * a.ny;
        }
        float cv[P][4], wv[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float up[4], dn[4], lf[4], rt[4], zu[4], zd[4], pm[4];
          lds<VEC>(ring[sc][p], lane, cv[p]);
          lds<VEC>(ring[su][p], lane, up);
          lds<VEC>(ring[sd][p], lane, dn);
          row_sides<VEC>(ring[sc][p], cv[p], hal[sc][p], lane, lf, rt);
          if constexpr (!TWO_D) {
            const float* b = L.wj + p * plane + base;
            if (z > 0)
              ldv<VEC>(b - zoff, lane, nv, zu);
            else
              zu[0] = zu[1] = zu[2] = zu[3] = 0.0f;
            if (z < a.nz - 1)
              ldv<VEC>(b + zoff, lane, nv, zd);
            else
              zd[0] = zd[1] = zd[2] = zd[3] = 0.0f;
          }
          if (j > 0) ldv<VEC>(wjm1 + p * plane + base, lane, nv, pm);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = vcol<VEC>(lane, e);
            float av = 0.0f;
            if (c < nv) {
              if constexpr (TWO_D)
                av = stencil<OP>(cv[p][e], up[e], dn[e], lf[e], rt[e], r,
                                 x0 + c, kf[e]) * a.ss;
              else
                av = stencil3d_vals<MODE>(
                    cv[p][e], up[e], dn[e], zu[e], zd[e], lf[e], rt[e],
                    Weights{nullptr, nullptr, nullptr}, 0, r, z, y, x0 + c,
                    a.nz, a.ny, nx, a.ss);
            }
            float wvv = L.s * av;
            if (j > 0) wvv = wvv - L.bs * pm[e];
            wv[p][e] = wvv;
          }
        }
        float* const wr = wt != nullptr ? wt + (size_t)t * P * PX
                                        : wrow + (size_t)w * P * PX;
        float* const wg = L.wg;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          sts<VEC>(wr + p * PX, lane, wv[p]);
          if (wg != nullptr) stv<VEC>(wg + p * plane + base, lane, nv, wv[p]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x[P], y2[P];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            x[p] = cv[p][e];
            y2[p] = wv[p][e];
          }
          hdot<P>(x, y2, dl);
          if (NSQ) {
            nj += x[0] * x[0];
            if (P == 2) nj += x[P - 1] * x[P - 1];
          }
        }
        if (j > 0) {
          __syncwarp();
          tile_dots<P, MAXW, true, VEC, LdNC>(wp, j, plane, wr, nullptr, base,
                                              nv, q, gl, g, d);
          __syncwarp();
        }
      }
    }
    __syncthreads();                              // the ring is reused
    sg += h;
  }
  raw_partials<MAXW, NSQ>(g, dl, nj, j, lane, w, q, gl, red, L.partial);
}

// Phase 1 over the block's segments [s0, s1), last to first, one row per
// warp: W_{j+1} = w - sum_{i < nw} q_i W_i (q as (re, im) pairs in qs) into
// wn_out, w from wsm (phase 0's rows) or, if wsm is null, from the field wg
// through L2; the block's partial sum of ||W_{j+1}||^2 to row 0 of partial.
// The arithmetic of pass2 (K4). wp: W_0..W_{nw-1} in shared memory.
template <int P, int VEC>
__device__ __forceinline__ void subpass(
    const float* const* wp, int nw, const float* qs, const OpArgs& a, int s0,
    int s1, const float* wsm, const float* wg, float* __restrict__ wn_out,
    float (*red)[RED_W], float* __restrict__ partial, int lane, int w) {
  const int nx = a.nx, rows = a.nz * a.ny;
  const size_t plane = (size_t)rows * nx;
  float nsq = 0.0f;
  for (int sg = s1 - 1 - w; sg >= s0; sg -= PWARP) {
    const int strip = sg / rows, r = sg - strip * rows;
    const int x0 = strip * PX, nv = nx - x0;
    const size_t base = (size_t)r * nx + x0;
    float acc[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (wsm != nullptr)
        lds<VEC>(wsm + ((size_t)(sg - s0) * P + p) * PX, lane, acc[p]);
      else
        ldv<VEC, LdL2>(wg + p * plane + base, lane, nv, acc[p]);
    }
#pragma unroll 4
    for (int i = 0; i < nw; ++i) {
      const float qr = qs[2 * i], qi = qs[2 * i + 1];
      float x[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
        ldv<VEC>(wp[i] + p * plane + base, lane, nv, x[p]);
      if (P == 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][e] = acc[0][e] - qr * x[0][e];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a0 = acc[0][e] - (qr * x[0][e] - qi * x[P - 1][e]);
          acc[P - 1][e] = acc[P - 1][e] - (qr * x[P - 1][e] + qi * x[0][e]);
          acc[0][e] = a0;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      stv<VEC>(wn_out + p * plane + base, lane, nv, acc[p]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      nsq += acc[0][e] * acc[0][e];
      if (P == 2) nsq += acc[P - 1][e] * acc[P - 1][e];
    }
  }
  nsq = warp_sum(nsq);
  if (lane == 0) red[w][0] = nsq;
  block_partials(red, 1, partial);
}

// ---------------------------------------------------------------- host side

// Most blocks any K5 launch uses: the partial-sum rows the caller
// allocates.
int coop_max_blocks() { return COOP_PER_SM * num_sms(); }

// Let `kernel` take as much dynamic shared memory as the card lets one
// block have beside its static shared memory; the CUDA error, or 0.
template <class K>
int allow_dyn_smem(K kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
  return (int)err;
}

// Launch `kernel` cooperatively on `grid` blocks of `threads` threads with
// `smem` bytes of dynamic shared memory; a grid of 0 (nothing fits) or a
// refused launch returns its error.
template <class K>
int coop_launch(K kernel, int grid, void** args, cudaStream_t st,
                int threads, size_t smem = 0) {
  if (grid <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(grid), dim3(threads), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
