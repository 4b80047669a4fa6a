// The phase bodies of a whole Lanczos iteration in one cooperative launch,
// for the fused iteration (K5, lanczos2d.cu iter_kernel), and the grid-wide
// pieces (reduce_all, coop_launch) that the resident SS2 step (K13,
// resident2d.cu) shares with it.
//
// One iteration j of the normalized two-pass loop (classical Gram-Schmidt
// with full reorthogonalization, the JAX package's _iter_call):
//   phase_w    w = s_j A(W_j) - bs W_{j-1} into a field, and the block's
//              partial sums of raw_i = <W_i, w>, i <= j;
//   grid sync; every block sums the partials (reduce_all);
//   phase_sub  W_{j+1} = w - sum_i q_i W_i with q_i = s_i^2 raw_i, and the
//              block's partial sum of ||W_{j+1}||^2.
//
// A cooperative launch holds all its blocks on the card at once, so the
// phases can be separated by grid syncs (cooperative_groups::this_grid()).
// Every block walks the cells in the same grid-stride order in every phase:
// a thread reads back the w it wrote itself. Data that other blocks wrote
// earlier in the same launch (the partial sums) is read
// from L2 with __ldcg, never through the read-only cache.
//
// Cross-block sums are deterministic and need no atomics: each block writes
// its partial sums, one row per output, and after the grid sync EVERY block
// sums all rows in the same fixed order, so every block holds the same bits
// of every scalar and computes the same coefficients from them.

#pragma once

#include <cooperative_groups.h>

#include "lz_common.cuh"
#include "lz_stencil.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int CT = 512;             // threads per block of a cooperative launch
constexpr int CWARP = CT / 32;
constexpr int COOP_PER_SM = 2;      // most blocks per SM a launch uses

// The operators of the phase bodies.
constexpr int OPK_ISO2D = 0;        // 5-point Laplacian (variant in op2.clean)
constexpr int OPK_ANISO2D = 1;      // div(c grad u), face weights in op2
constexpr int OPK_ISO3D_REF = 2;    // 7-point Laplacian with the y-seam
constexpr int OPK_ISO3D_CLEAN = 3;  // 7-point Laplacian without it

struct OpArgs {
  Op2d op2;          // 2D operators' weights or variant
  int nz, ny, nx;    // the grid; 2D has nz = 1, rows = nz * ny
  float ss;          // scale * sign
};

template <int OPK, class LD>
__device__ __forceinline__ float apply_op(const float* b, size_t idx, int r,
                                          int x, const OpArgs& a) {
  if (OPK == OPK_ISO2D || OPK == OPK_ANISO2D)
    return stencil2d<OPK == OPK_ISO2D ? OP_ISO : OP_ANISO, LD>(
        b, a.op2, idx, r, x, a.ny, a.nx, a.ss);
  const int z = r / a.ny, y = r - z * a.ny;
  const Weights none = {nullptr, nullptr, nullptr};
  return stencil3d<OPK == OPK_ISO3D_REF ? ISO_REF : ISO_CLEAN, LD>(
      b, none, idx, r, z, y, x, a.nz * a.ny, a.nz, a.ny, a.nx, a.ss);
}

// Basis columns W_0..W_j: a list of j pointers and W_j.
struct ColList {
  Cols c;
  const float* last;
  int j;
  __device__ __forceinline__ const float* operator()(int i) const {
    return i < j ? c.p[i] : last;
  }
};

// Block sum of a per-thread value into red[warp][o].
__device__ __forceinline__ void cput(float (*red)[RED_W], int o, float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5][o] = v;
}

// The block's sums, one row of gridDim.x per output: partial[o][block].
__device__ __forceinline__ void cwrite(float (*red)[RED_W], int nout,
                                       float* partial) {
  __syncthreads();
  for (int o = threadIdx.x; o < nout; o += CT) {
    float v = red[0][o];
#pragma unroll
    for (int w = 1; w < CWARP; ++w) v += red[w][o];
    partial[(size_t)o * gridDim.x + blockIdx.x] = v;
  }
}

// After a grid sync, in every block of NW warps: out[o] = sum_b
// partial[o][b], o < nout, in one fixed order (lane l adds b = l, l + 32,
// ..., then the warp's shuffle tree), so every block gets the same bits.
// out is shared memory.
template <int NW = CWARP>
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

// Phase 0 of iteration j: w = s A(W_j) - bs W_{j-1} into w_out, and the
// partial sums of raw_i = <W_i, w> at rows 2i (re), 2i + 1 (im), i <= j.
// The arithmetic of pass1 (K1/K1'/pass1_3d), cell by cell. MAXW bounds j.
template <int P, int MAXW, int OPK, class LD, class COLS>
__device__ __forceinline__ void phase_w(float s, float bs, const COLS& W,
                                        int j, const OpArgs& a, float* w_out,
                                        float (*red)[RED_W], float* partial) {
  const int nx = a.nx;
  const size_t n = (size_t)a.nz * a.ny * nx;
  const size_t stride = (size_t)gridDim.x * CT;
  const float* wj = W(j);
  const float* wjm1 = j > 0 ? W(j - 1) : nullptr;
  float acc[MAXW][2] = {};
  float accj[2] = {0.0f, 0.0f};
  for (size_t e = (size_t)blockIdx.x * CT + threadIdx.x; e < n; e += stride) {
    const int r = (int)(e / nx);
    const int x = (int)(e - (size_t)r * nx);
    float c[P], w[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float* b = wj + p * n;
      const float av = apply_op<OPK, LD>(b, e, r, x, a);
      float wv = s * av;
      if (j > 0) wv = wv - bs * LD::ld(wjm1 + p * n + e);
      c[p] = LD::ld(b + e);
      w[p] = wv;
      w_out[p * n + e] = wv;
    }
    hdot<P>(c, w, accj);
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      if (i < j) {
        float wi[P];
#pragma unroll
        for (int p = 0; p < P; ++p) wi[p] = LD::ld(W(i) + p * n + e);
        hdot<P>(wi, w, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i < j) {
      cput(red, 2 * i, acc[i][0]);
      cput(red, 2 * i + 1, acc[i][1]);
    }
  }
  cput(red, 2 * j, accj[0]);
  cput(red, 2 * j + 1, accj[1]);
  cwrite(red, 2 * (j + 1), partial);
}

// Phase 1 of iteration j: W_{j+1} = w - sum_{i<=j} q_i W_i, q_i = s_i^2
// raw_i (raw as (re, im) pairs, s_i in sv), into wn_out, which may be w
// itself: a thread reads each of its cells before it writes it. The
// partial sum of ||W_{j+1}||^2 goes to row 0 of partial. The arithmetic of
// pass2 (K4). MAXW bounds j + 1.
template <int P, int MAXW, class LD, class COLS>
__device__ __forceinline__ void phase_sub(const COLS& W, int j,
                                          const float* sv, const float* raw,
                                          size_t n, const float* w,
                                          float* wn_out, float (*red)[RED_W],
                                          float* partial) {
  const size_t stride = (size_t)gridDim.x * CT;
  float q[MAXW][2];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    const float si = i <= j ? sv[i] : 0.0f;
    q[i][0] = i <= j ? si * si * raw[2 * i] : 0.0f;
    q[i][1] = i <= j ? si * si * raw[2 * i + 1] : 0.0f;
  }
  float nsq = 0.0f;
  for (size_t e = (size_t)blockIdx.x * CT + threadIdx.x; e < n; e += stride) {
    float a0 = __ldcg(w + e);
    float a1 = P == 2 ? __ldcg(w + n + e) : 0.0f;
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      if (i <= j) {
        const float* wi = W(i);
        const float w0 = LD::ld(wi + e);
        if (P == 1) {
          a0 = a0 - q[i][0] * w0;
        } else {
          const float w1 = LD::ld(wi + n + e);
          a0 = a0 - (q[i][0] * w0 - q[i][1] * w1);
          a1 = a1 - (q[i][0] * w1 + q[i][1] * w0);
        }
      }
    }
    wn_out[e] = a0;
    nsq += a0 * a0;
    if (P == 2) {
      wn_out[n + e] = a1;
      nsq += a1 * a1;
    }
  }
  cput(red, 0, nsq);
  cwrite(red, 1, partial);
}

// Blocks of a cooperative launch of `kernel` with CT threads: as many as
// fit on the card at once, at most COOP_PER_SM per SM; 0 if none fits.
template <class K>
int coop_blocks(K kernel) {
  int dev = 0, sms = 0, occ = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, CT, 0)
             != cudaSuccess)
    return 0;
  return (occ < COOP_PER_SM ? occ : COOP_PER_SM) * sms;
}

// Most blocks any cooperative launch here uses: the partial-sum rows the
// caller allocates.
int coop_max_blocks() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess)
    return 0;
  return COOP_PER_SM * sms;
}

// Launch `kernel` cooperatively on `grid` blocks of `threads` threads; a
// grid of 0 (nothing fits) or a refused launch returns its error.
template <class K>
int coop_launch(K kernel, int grid, void** args, cudaStream_t st,
                int threads = CT) {
  if (grid <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(grid), dim3(threads), args, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
