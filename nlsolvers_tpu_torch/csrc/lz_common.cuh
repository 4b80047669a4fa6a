// Shared pieces of the hand-written Lanczos kernels (lanczos2d.cu,
// lanczos3d.cu): the block shape, the column-pointer struct, the Hermitian
// dot on planar fields, and the two-stage deterministic reduction.
//
// Fields are planar float32 (P, rows, nx): P = 2 holds (re, im) planes of a
// complex field, P = 1 a real field. <a, b> is the Hermitian product
// sum conj(a) b, returned as (re, im).
//
// Cross-block reductions are two-stage and deterministic: each block writes
// its partial sums to a scratch buffer (warp shuffles, then a fixed sum over
// the block's warps), and reduce_partials sums those in a fixed order. No
// atomics, so results repeat bit for bit from run to run.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TX = 128;        // columns per block = threads per block
constexpr int TY = 8;          // rows per block
constexpr int NWARP = TX / 32;
constexpr int MAXCOLS = 32;    // longest basis list a launch takes
constexpr int RED_THREADS = 256;
// most per-block partial sums: lanczos2d's K2 nsq, gram (2 nw), d (2 (nw+1))
constexpr int RED_W = 4 * MAXCOLS + 3;

struct Cols { const float* p[MAXCOLS]; };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// acc += conj(a) * b
template <int P>
__device__ __forceinline__ void hdot(const float* a, const float* b,
                                     float* acc) {
  if (P == 1) {
    acc[0] += a[0] * b[0];
  } else {
    acc[0] += a[0] * b[0] + a[1] * b[1];
    acc[1] += a[0] * b[1] - a[1] * b[0];
  }
}

template <int P>
__device__ __forceinline__ void load(const float* __restrict__ f, size_t idx,
                                     size_t plane, float* v) {
  v[0] = __ldg(f + idx);
  if (P == 2) v[1] = __ldg(f + plane + idx);
}

// Reduce one per-thread value over the block's warps into red[warp][o].
__device__ __forceinline__ void put(float (*red)[RED_W], int o,
                                    float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5][o] = v;
}

__device__ __forceinline__ void write_partials(
    float (*red)[RED_W], int nout, float* __restrict__ partial) {
  __syncthreads();
  const size_t bid = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  for (int o = threadIdx.x; o < nout; o += TX) {
    float v = red[0][o];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) v += red[w][o];
    partial[bid * nout + o] = v;
  }
}

// Second stage: out[o] = sum_b partial[b, o] in a fixed order.
__global__ void reduce_partials(const float* __restrict__ partial, int nblk,
                                int nout, float* __restrict__ out) {
  __shared__ float ws[RED_THREADS / 32];
  const int o = blockIdx.x;
  float acc = 0.0f;
  for (int b = threadIdx.x; b < nblk; b += RED_THREADS)
    acc += partial[(size_t)b * nout + o];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = ws[0];
#pragma unroll
    for (int w = 1; w < RED_THREADS / 32; ++w) s += ws[w];
    out[o] = s;
  }
}

// Template bucket for a column count: per-column accumulators live in
// register arrays sized 4, 8, 16 or 32.
int bucket(int n) { return n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32; }

dim3 tile_grid(int ny, int nx) {
  return dim3((nx + TX - 1) / TX, (ny + TY - 1) / TY);
}

Cols make_cols(const float* const* ptrs, int n) {
  Cols c = {};
  for (int i = 0; i < n; ++i) c.p[i] = ptrs[i];
  return c;
}

}  // namespace
