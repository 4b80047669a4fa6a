// Shared pieces of the hand-written Lanczos kernels (lanczos2d.cu,
// lanczos3d.cu, resident2d.cu): the block shape, the column-pointer struct,
// the Hermitian dot on planar fields, the pipe kernels' rebuild of
// W_{j+1}, and the two-stage deterministic reduction.
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

// Column pointers of a launch. A batched launch (lanes on blockIdx.y) takes
// lane 0's pointers and the lane stride ls, in floats (0 unbatched): lane
// b's column i is p[i] + b ls.
struct Cols {
  const float* p[MAXCOLS];
  size_t ls;
};

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

// As write_partials, for a block of nwarp warps whose partial-sum row is blk.
__device__ __forceinline__ void write_partials_n(float (*red)[RED_W],
                                                 int nwarp, int nout,
                                                 size_t blk,
                                                 float* __restrict__ partial) {
  __syncthreads();
  for (int o = threadIdx.x; o < nout; o += nwarp * 32) {
    float v = red[0][o];
    for (int w = 1; w < nwarp; ++w) v += red[w][o];
    partial[blk * nout + o] = v;
  }
}

// W_{j+1} = s av_j - sum_i c_i W_i at one point from av_j and W_0..W_j
// (the order of operations of the Pallas pipe kernels' reconstruction),
// lanczos3d.cu's pipe_3d; lanczos2d.cu's K2 (rebuild_row) keeps this order
// on four points at a time.
template <int P, int MAXW>
__device__ __forceinline__ void rebuild(const float* __restrict__ av,
                                        const Cols& W, int nw, float s,
                                        const float (&cf)[MAXW][2],
                                        size_t idx, size_t plane, float* v) {
  float a0 = s * __ldg(av + idx);
  float a1 = P == 2 ? s * __ldg(av + plane + idx) : 0.0f;
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i < nw) {
      const float w0 = __ldg(W.p[i] + idx);
      if (P == 1) {
        a0 = a0 - cf[i][0] * w0;
      } else {
        const float w1 = __ldg(W.p[i] + plane + idx);
        a0 = a0 - (cf[i][0] * w0 - cf[i][1] * w1);
        a1 = a1 - (cf[i][0] * w1 + cf[i][1] * w0);
      }
    }
  }
  v[0] = a0;
  if (P == 2) v[1] = a1;
}

// Second stage: out[o] = sum_b partial[b, o] in a fixed order. A batched
// launch stacks its lanes' (nblk, nout) partials and outputs lane-major:
// blockIdx.y is the lane.
__global__ void reduce_partials(const float* __restrict__ partial, int nblk,
                                int nout, float* __restrict__ out) {
  __shared__ float ws[RED_THREADS / 32];
  const int o = blockIdx.x;
  partial += (size_t)blockIdx.y * nblk * nout;
  out += (size_t)blockIdx.y * nout;
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

// As reduce_partials, for partial sums stored output-major, partial[o, b]
// (nblk sums per output): consecutive threads read consecutive blocks' sums.
// A batched launch stacks its lanes' rows, lane-major: blockIdx.y is the
// lane, so lane l's output o is row l * gridDim.x + o.
__global__ void reduce_partials_om(const float* __restrict__ partial,
                                   int nblk, float* __restrict__ out) {
  __shared__ float ws[RED_THREADS / 32];
  const size_t o = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const float* __restrict__ row = partial + o * nblk;
  float acc = 0.0f;
  for (int b = threadIdx.x; b < nblk; b += RED_THREADS) acc += row[b];
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

Cols make_cols(const float* const* ptrs, int n, size_t ls = 0) {
  Cols c = {};
  for (int i = 0; i < n; ++i) c.p[i] = ptrs[i];
  c.ls = ls;
  return c;
}

}  // namespace
