// Hand-written Hopper (sm_90a) kernels for the 3D Lanczos matrix-function
// loops and the 3D no-flux ghost copy.
//
// Replaces these Pallas TPU kernels of nlsolvers_tpu/ops/pallas/:
//   pass1_3d <- lanczos3d_pipe.py _pass1y_call (K6) and _pass1zy_call (K7),
//               and lanczos2d.py _pass1_call in modes iso3d/aniso3d (K1'):
//        w = s_j A(W_j) - bs W_{j-1}, fused with raw_i = <W_i, w>, i <= j
//   pass2    <- lanczos2d.py _pass2_call (K4):
//        w' = w - sum_{i<=j} q_i W_i (complex q_i), fused with ||w'||^2
//   pipe_3d  <- lanczos3d_pipe.py _pipe3d_call (K8), the opt-in 3D pipe:
//        pass2(j) fused with pass1(j+1), K2's outputs (lanczos2d.cu)
//   bc3d     <- bc3d.py _bc_call (K14): the 6-face no-flux ghost copy, on
//               the whole grid or on one shard's block (global offsets)
//   pass1_shard3d <- lanczos3d_pipe.py _pass1y_shard_call (K9),
//               _pass1y_shard_aniso_call (K10), _pass1zy_shard_call (K11),
//               _pass1zy_shard_aniso_call (K12), and lanczos2d.py
//               _pass1_call in modes shard3d/shard3d_aniso (K1'): pass1_3d
//               on one shard's block of a sharded grid, the shard modes
//               SHARD_REF, SHARD_CLEAN, SHARD_ANISO of the same kernel
//
// The TPU split pass1 into y-slab and z-by-y brick kernels (and their
// sharded twins) only to fit its blocks into VMEM; the function is the
// same, so here it is one kernel with the operator as a mode. On a shard
// the neighbours outside the block come from halo arrays that only the
// threads at the block's edges read, and the iso diagonal from the block's
// global offsets (lz_stencil.cuh's stencil3d_shard), so a shard costs what
// an unsharded block of its size costs, plus its halos.
//
// Fields are planar float32 (P, R, nx) on the merged row view R = nz * ny;
// the operator modes (ISO_REF with the reference's y-seam, ISO_CLEAN,
// ANISO) and their stencil are lz_stencil.cuh's.
//
// What bounds them on an H100: bytes streamed from device memory; the
// arithmetic is a few flops per loaded float. pass1 at iteration j reads
// j + 1 columns and writes 1 (plus three weight planes for ANISO), pass2
// reads j + 2 and writes 1, pipe_3d reads j + 2 and writes 2. At 128^3
// complex64 a column is 16.8 MB.
//
// What the design does about it:
// * pass1: a block owns a TY x TX tile of the merged view and walks it row
//   by row. Each column is read from device memory about once: the y
//   neighbours of a row were loaded one row step earlier (L1), the z
//   neighbours (ny rows away) are loaded by the blocks of the next and the
//   previous plane at about the same time (L2). The diagonal comes from the
//   indices, so it costs no traffic.
// * pass2 is a flat stream over the R * nx points of each plane, one
//   element per thread per step of a grid-stride loop with a fixed grid, so
//   its partial sums (and the result) repeat bit for bit.
// * pipe_3d rebuilds W_{j+1} on its tile and the tile's halo into a
//   3-plane ring in shared memory while it marches z, so the stencil of
//   the column it builds needs no second pass (see its kernel).
// * bc3d writes only the faces, in place. With the reference's order (x
//   faces on interior y and z, then y faces on interior z, then z faces)
//   every face cell ends up holding u(clamp(z), clamp(y), clamp(x)), where
//   clamp maps 0 to 1 and n-1 to n-2: an interior cell that no thread
//   writes, so one kernel does the whole copy without a race. Its bytes are
//   the faces', not the volume's.
// * Scalars (s_j, bs, q_i, c_i) are read from a device buffer, and the
//   reductions are two-stage and deterministic (lz_common.cuh).
//
// Plain C interface for ctypes: every launcher returns cudaGetLastError().

#include "lz_common.cuh"
#include "lz_stencil.cuh"

namespace {

// Blocks of the pass2 grid-stride loop: about 16 blocks of TX threads on
// each of the H100's 132 SMs.
constexpr int PASS2_BLOCKS = 132 * 16;

// ------------------------------------------------------------ pass1_3d
// MAXW bounds j (the number of earlier columns) so the per-column
// accumulators stay in registers.
// The shard modes take their halos, offsets and edge face weights from sh
// (unused otherwise); nz, ny, nx are then the block's.
template <int P, int MAXW, int MODE>
__global__ void __launch_bounds__(TX) pass1_3d_kernel(
    const float* __restrict__ scal, const float* __restrict__ wj, Cols prev,
    const float* __restrict__ wjm1, int j, Weights wt, Shard3d sh,
    float* __restrict__ w_out, float* __restrict__ partial, int nz, int ny,
    int nx, float ss) {
  __shared__ float red[NWARP][RED_W];
  const int R = nz * ny;
  const int t = threadIdx.x;
  const int x = blockIdx.x * TX + t;
  const int r0 = blockIdx.y * TY;
  const int rows = min(TY, R - r0);
  const size_t plane = (size_t)R * nx;
  const float s = scal[0], bs = scal[1];

  float acc[MAXW][2] = {};
  float accj[2] = {0.0f, 0.0f};
  if (x < nx) {
    for (int rr = 0; rr < rows; ++rr) {
      const int r = r0 + rr;
      const int z = r / ny, y = r - z * ny;
      const size_t idx = (size_t)r * nx + x;
      float c[P], w[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* __restrict__ b = wj + p * plane;
        float av;
        if constexpr (MODE >= SHARD_REF)
          av = stencil3d_shard<MODE>(b, p, wt, sh, idx, r, z, y, x, R, nz, ny,
                                     nx, ss);
        else
          av = stencil3d<MODE>(b, wt, idx, r, z, y, x, R, nz, ny, nx, ss);
        float wv = s * av;
        if (j > 0) wv = wv - bs * __ldg(wjm1 + p * plane + idx);
        c[p] = __ldg(b + idx);
        w[p] = wv;
        w_out[p * plane + idx] = wv;
      }
      hdot<P>(c, w, accj);
#pragma unroll
      for (int i = 0; i < MAXW; ++i) {
        if (i < j) {
          float wi[P];
          load<P>(prev.p[i], idx, plane, wi);
          hdot<P>(wi, w, acc[i]);
        }
      }
    }
  }
  // partial layout: raw_i at (2i, 2i+1), i <= j
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i < j) {
      put(red, 2 * i, acc[i][0]);
      put(red, 2 * i + 1, acc[i][1]);
    }
  }
  put(red, 2 * j, accj[0]);
  put(red, 2 * j + 1, accj[1]);
  write_partials(red, 2 * (j + 1), partial);
}

// ------------------------------------------------------------ pass2
// MAXW bounds nw = j + 1 so the coefficients stay in registers.
template <int P, int MAXW>
__global__ void __launch_bounds__(TX) pass2_kernel(
    const float* __restrict__ q, const float* __restrict__ w, Cols W, int nw,
    float* __restrict__ wn_out, float* __restrict__ partial, size_t n) {
  __shared__ float red[NWARP][RED_W];
  float cf[MAXW][2];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    cf[i][0] = i < nw ? q[2 * i] : 0.0f;
    cf[i][1] = i < nw ? q[2 * i + 1] : 0.0f;
  }
  float nsq = 0.0f;
  const size_t stride = (size_t)gridDim.x * TX;
  for (size_t e = (size_t)blockIdx.x * TX + threadIdx.x; e < n; e += stride) {
    float a0 = __ldg(w + e);
    float a1 = P == 2 ? __ldg(w + n + e) : 0.0f;
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      if (i < nw) {
        const float w0 = __ldg(W.p[i] + e);
        if (P == 1) {
          a0 = a0 - cf[i][0] * w0;
        } else {
          const float w1 = __ldg(W.p[i] + n + e);
          a0 = a0 - (cf[i][0] * w0 - cf[i][1] * w1);
          a1 = a1 - (cf[i][0] * w1 + cf[i][1] * w0);
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
  put(red, 0, nsq);
  write_partials(red, 1, partial);
}

// ------------------------------------------------------------ pipe_3d
// K8: one pipelined iteration j on the 3D operators, K2's design lifted to
// 3D. A block owns a PY x PX tile of (y, x) and marches over PZ planes of
// z. Step zr rebuilds W_{j+1} = s av_j - sum_i c_i W_i on plane zr of its
// tile and on the tile's halo ring (one row and one column on each side),
// into a 3-plane ring in shared memory, and then applies the operator to
// plane zr-1 from the ring. The halo rows are the merged rows z ny + y0 - 1
// and z ny + y0 + PY, so the y-seam of the reference operator and the
// boundaries come from the merged row index as in pass1_3d; plane z0-1
// and z1 are rebuilt once more than they are stencilled. Every input column
// is read from device memory about once per launch: the halo cells, the
// neighbouring blocks' own cells, mostly come from L2.
constexpr int PX = 32, PY = 8, PZ = 16;
constexpr int PT = PX * PY;                       // threads per block
constexpr int PHALO = 2 * (PX + 2) + 2 * PY;      // halo cells of a plane

template <int P, int MAXW, int MODE>
__global__ void __launch_bounds__(PT) pipe3d_kernel(
    const float* __restrict__ scal, const float* __restrict__ av, Cols W,
    int nw, Weights wt, float* __restrict__ wn_out,
    float* __restrict__ av_out, float* __restrict__ partial, int nz, int ny,
    int nx, float ss) {
  __shared__ float red[PT / 32][RED_W];
  __shared__ float ring[3][P][PY + 2][PX + 2];
  const int t = threadIdx.x;
  const int tx = t % PX, ty = t / PX;
  const int x0 = blockIdx.x * PX, y0 = blockIdx.y * PY, z0 = blockIdx.z * PZ;
  const int z1 = min(z0 + PZ, nz);
  const int x = x0 + tx, y = y0 + ty;
  const bool in = x < nx && y < ny;
  const long long R = (long long)nz * ny;
  const size_t plane = (size_t)R * nx;

  const float s = scal[0];
  float cf[MAXW][2];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    cf[i][0] = i < nw ? scal[2 + 2 * i] : 0.0f;
    cf[i][1] = i < nw ? scal[3 + 2 * i] : 0.0f;
  }
  // this thread's halo cell, if any: ring row hr, column hc
  int hr = -1, hc = 0;
  if (t < PX + 2) {
    hr = 0;
    hc = t;
  } else if (t < 2 * (PX + 2)) {
    hr = PY + 1;
    hc = t - (PX + 2);
  } else if (t < 2 * (PX + 2) + PY) {
    hr = 1 + t - 2 * (PX + 2);
    hc = 0;
  } else if (t < PHALO) {
    hr = 1 + t - 2 * (PX + 2) - PY;
    hc = PX + 1;
  }

  float nsq = 0.0f;
  float g[MAXW][2] = {};
  float d[MAXW][2] = {};
  float dl[2] = {0.0f, 0.0f};     // d_{j+1} = <W_{j+1}, av_{j+1}>

  for (int zr = z0 - 1; zr <= z1; ++zr) {
    const int slot = (zr + 3) % 3;
    const bool zok = zr >= 0 && zr < nz;
    // ring cell (ty+1, tx+1): merged row zr ny + y (past ny on a ragged
    // tile: the next plane's first row, the y-seam's neighbour)
    float v[P];
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = 0.0f;
    const long long rv = (long long)zr * ny + y;
    if (zok && x < nx && rv < R)
      rebuild<P, MAXW>(av, W, nw, s, cf, (size_t)rv * nx + x, plane, v);
    if (in && zr >= z0 && zr < z1) {
      const size_t idx = (size_t)rv * nx + x;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        wn_out[p * plane + idx] = v[p];
        nsq += v[p] * v[p];
      }
#pragma unroll
      for (int i = 0; i < MAXW; ++i) {
        if (i < nw) {
          float wi[P];
          load<P>(W.p[i], idx, plane, wi);
          hdot<P>(wi, v, g[i]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) ring[slot][p][ty + 1][tx + 1] = v[p];
    if (hr >= 0) {
      const long long rh = (long long)zr * ny + y0 - 1 + hr;
      const int xh = x0 - 1 + hc;
      float h[P];
#pragma unroll
      for (int p = 0; p < P; ++p) h[p] = 0.0f;
      if (zok && rh >= 0 && rh < R && xh >= 0 && xh < nx)
        rebuild<P, MAXW>(av, W, nw, s, cf, (size_t)rh * nx + xh, plane, h);
#pragma unroll
      for (int p = 0; p < P; ++p) ring[slot][p][hr][hc] = h[p];
    }
    __syncthreads();
    const int zs = zr - 1;                  // the plane to stencil
    if (in && zs >= z0 && zs < z1) {
      const int sc = (zs + 3) % 3, su = (zs + 2) % 3;
      const int r = zs * ny + y;
      const size_t idx = (size_t)r * nx + x;
      float a[P], c[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        c[p] = ring[sc][p][ty + 1][tx + 1];
        a[p] = stencil3d_vals<MODE>(
            c[p], ring[sc][p][ty][tx + 1], ring[sc][p][ty + 2][tx + 1],
            ring[su][p][ty + 1][tx + 1], ring[slot][p][ty + 1][tx + 1],
            ring[sc][p][ty + 1][tx], ring[sc][p][ty + 1][tx + 2], wt, idx, r,
            zs, y, x, nz, ny, nx, ss);
        av_out[p * plane + idx] = a[p];
      }
#pragma unroll
      for (int i = 0; i < MAXW; ++i) {
        if (i < nw) {
          float wi[P];
          load<P>(W.p[i], idx, plane, wi);
          hdot<P>(wi, a, d[i]);
        }
      }
      hdot<P>(c, a, dl);
    }
    __syncthreads();                        // the ring slot is rewritten
  }

  // partial layout, as K2's: nsq | gram_i (re, im), i < nw | d_i, i <= nw
  put(red, 0, nsq);
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i < nw) {
      put(red, 1 + 2 * i, g[i][0]);
      put(red, 2 + 2 * i, g[i][1]);
    }
  }
  const int nout = 1 + 2 * nw;
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i < nw) {
      put(red, nout + 2 * i, d[i][0]);
      put(red, nout + 2 * i + 1, d[i][1]);
    }
  }
  put(red, nout + 2 * nw, dl[0]);
  put(red, nout + 2 * nw + 1, dl[1]);
  const size_t blk = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                     + blockIdx.x;
  write_partials_n(red, PT / 32, nout + 2 * (nw + 1), blk, partial);
}

dim3 pipe3d_grid(int nz, int ny, int nx) {
  return dim3((nx + PX - 1) / PX, (ny + PY - 1) / PY, (nz + PZ - 1) / PZ);
}

template <int P, int MODE>
void launch_pipe3d(int b, const float* scal, const float* av, Cols W, int nw,
                   Weights wt, float* wn, float* avn, float* partial, int nz,
                   int ny, int nx, float ss, cudaStream_t st) {
  const dim3 g = pipe3d_grid(nz, ny, nx);
#define LZ_P3(BB) pipe3d_kernel<P, BB, MODE><<<g, PT, 0, st>>>( \
      scal, av, W, nw, wt, wn, avn, partial, nz, ny, nx, ss)
  if (b == 4) LZ_P3(4);
  else if (b == 8) LZ_P3(8);
  else if (b == 16) LZ_P3(16);
  else LZ_P3(32);
#undef LZ_P3
}

template <int P>
void pipe3d_mode(int mode, int b, const float* scal, const float* av, Cols W,
                 int nw, Weights wt, float* wn, float* avn, float* partial,
                 int nz, int ny, int nx, float ss, cudaStream_t st) {
  if (mode == ISO_REF)
    launch_pipe3d<P, ISO_REF>(b, scal, av, W, nw, wt, wn, avn, partial, nz,
                              ny, nx, ss, st);
  else if (mode == ISO_CLEAN)
    launch_pipe3d<P, ISO_CLEAN>(b, scal, av, W, nw, wt, wn, avn, partial, nz,
                                ny, nx, ss, st);
  else
    launch_pipe3d<P, ANISO>(b, scal, av, W, nw, wt, wn, avn, partial, nz, ny,
                            nx, ss, st);
}

// ------------------------------------------------------------ bc3d
// clamp(v) of a face cell: 0 -> 1 where the block holds the domain's low
// face (lo), n-1 -> n-2 where it holds the high one (hi).
__device__ __forceinline__ int clamp_in(int v, int n, int lo, int hi) {
  return lo && v == 0 ? 1 : (hi && v == n - 1 ? n - 2 : v);
}

// One thread per face cell of the (nz, ny, nx) block at global offsets
// (z0, y0, x0) of an (NZ, NY, NX) grid: the cells are enumerated without
// overlap, the block's z-face planes (all y, x), then its y-face rows on the
// planes that are not z faces (all x), then its x-face columns on the rows
// that are neither. Unsharded, the block is the grid.
template <int P>
__global__ void __launch_bounds__(256) bc3d_kernel(float* __restrict__ u,
                                                   int nz, int ny, int nx,
                                                   int z0, int y0, int x0,
                                                   int NZ, int NY, int NX) {
  const int zl = z0 == 0, zh = z0 + nz == NZ;
  const int yl = y0 == 0, yh = y0 + ny == NY;
  const int xl = x0 == 0, xh = x0 + nx == NX;
  const long long izn = nz - zl - zh, iyn = ny - yl - yh;
  const long long zf = (long long)ny * nx, yf = izn * nx, xf = izn * iyn;
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int z, y, x;
  if (k < (zl + zh) * zf) {
    z = zl && k < zf ? 0 : nz - 1;
    k %= zf;
    y = (int)(k / nx);
    x = (int)(k % nx);
  } else if ((k -= (zl + zh) * zf) < (yl + yh) * yf) {
    y = yl && k < yf ? 0 : ny - 1;
    k %= yf;
    z = zl + (int)(k / nx);
    x = (int)(k % nx);
  } else if ((k -= (yl + yh) * yf) < (xl + xh) * xf) {
    x = xl && k < xf ? 0 : nx - 1;
    k %= xf;
    z = zl + (int)(k / iyn);
    y = yl + (int)(k % iyn);
  } else {
    return;
  }
  const size_t plane = (size_t)nz * ny * nx;
  const size_t dst = ((size_t)z * ny + y) * nx + x;
  const size_t src = ((size_t)clamp_in(z, nz, zl, zh) * ny
                      + clamp_in(y, ny, yl, yh)) * nx + clamp_in(x, nx, xl, xh);
#pragma unroll
  for (int p = 0; p < P; ++p) u[p * plane + dst] = u[p * plane + src];
}

template <int P, int MAXW, int MODE>
void launch_pass1(const float* scal, const float* wj, Cols prev, int j,
                  Weights wt, const Shard3d& sh, float* w, float* partial,
                  int nz, int ny, int nx, float ss, cudaStream_t st) {
  pass1_3d_kernel<P, MAXW, MODE><<<tile_grid(nz * ny, nx), TX, 0, st>>>(
      scal, wj, prev, j > 0 ? prev.p[j - 1] : nullptr, j, wt, sh, w, partial,
      nz, ny, nx, ss);
}

template <int P, int MODE>
void pass1_bucket(int b, const float* scal, const float* wj, Cols prev,
                  int j, Weights wt, const Shard3d& sh, float* w,
                  float* partial, int nz, int ny, int nx, float ss,
                  cudaStream_t st) {
#define LZ_B(BB) launch_pass1<P, BB, MODE>(scal, wj, prev, j, wt, sh, w, \
                                           partial, nz, ny, nx, ss, st)
  if (b == 4) LZ_B(4);
  else if (b == 8) LZ_B(8);
  else if (b == 16) LZ_B(16);
  else LZ_B(32);
#undef LZ_B
}

template <int P>
void pass1_mode(int mode, int b, const float* scal, const float* wj,
                Cols prev, int j, Weights wt, const Shard3d& sh, float* w,
                float* partial, int nz, int ny, int nx, float ss,
                cudaStream_t st) {
#define LZ_M(MM) pass1_bucket<P, MM>(b, scal, wj, prev, j, wt, sh, w, \
                                     partial, nz, ny, nx, ss, st)
  switch (mode) {
    case ISO_REF: LZ_M(ISO_REF); break;
    case ISO_CLEAN: LZ_M(ISO_CLEAN); break;
    case ANISO: LZ_M(ANISO); break;
    case SHARD_REF: LZ_M(SHARD_REF); break;
    case SHARD_CLEAN: LZ_M(SHARD_CLEAN); break;
    default: LZ_M(SHARD_ANISO); break;
  }
#undef LZ_M
}

// pass1_3d (any mode), then the reduction of its partial sums.
int pass1_any(int P, int mode, const float* scal, const float* wj,
              const float* const* prev, int j, Weights wt, const Shard3d& sh,
              float* w, float* partial, float* raw, int nz, int ny, int nx,
              float ss, cudaStream_t st) {
  const Cols c = make_cols(prev, j);
  const int b = bucket(j);
  if (P == 1)
    pass1_mode<1>(mode, b, scal, wj, c, j, wt, sh, w, partial, nz, ny, nx, ss,
                  st);
  else
    pass1_mode<2>(mode, b, scal, wj, c, j, wt, sh, w, partial, nz, ny, nx, ss,
                  st);
  const int nout = 2 * (j + 1);
  const dim3 g = tile_grid(nz * ny, nx);
  reduce_partials<<<nout, RED_THREADS, 0, st>>>(partial, (int)(g.x * g.y),
                                                nout, raw);
  return (int)cudaGetLastError();
}

template <int P>
void launch_pass2(int b, const float* q, const float* w, Cols W, int nw,
                  float* wn, float* partial, size_t n, cudaStream_t st) {
  if (b == 4)
    pass2_kernel<P, 4><<<PASS2_BLOCKS, TX, 0, st>>>(q, w, W, nw, wn, partial,
                                                    n);
  else if (b == 8)
    pass2_kernel<P, 8><<<PASS2_BLOCKS, TX, 0, st>>>(q, w, W, nw, wn, partial,
                                                    n);
  else if (b == 16)
    pass2_kernel<P, 16><<<PASS2_BLOCKS, TX, 0, st>>>(q, w, W, nw, wn,
                                                     partial, n);
  else
    pass2_kernel<P, 32><<<PASS2_BLOCKS, TX, 0, st>>>(q, w, W, nw, wn,
                                                     partial, n);
}

}  // namespace

extern "C" {

// Number of blocks (= partial-sum rows) a pass1_3d launch uses.
int lz3_pass1_blocks(int nz, int ny, int nx) {
  const dim3 g = tile_grid(nz * ny, nx);
  return (int)(g.x * g.y);
}

// Number of blocks (= partial-sum rows) a pass2 launch uses.
int lz3_pass2_blocks() { return PASS2_BLOCKS; }

int lz3_max_cols() { return MAXCOLS; }

const char* lz3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// pass1_3d. mode: 0 iso reference, 1 iso clean, 2 aniso (wx, wy, wz are
// (R, nx) device arrays; null otherwise). prev: host array of j device
// pointers W_0..W_{j-1}. partial: scratch of lz3_pass1_blocks * 2(j+1)
// floats. raw: (j+1, 2) output.
int lz3_pass1(int P, int mode, const float* scal, const float* wj,
              const float* const* prev, int j, const float* wx,
              const float* wy, const float* wz, float* w, float* partial,
              float* raw, int nz, int ny, int nx, float ss, cudaStream_t st) {
  if ((P != 1 && P != 2) || mode < 0 || mode > 2 || j < 0
      || j + 1 > MAXCOLS || nz < 3 || ny < 3 || nx < 3)
    return (int)cudaErrorInvalidValue;
  if (mode == ANISO && (!wx || !wy || !wz)) return (int)cudaErrorInvalidValue;
  return pass1_any(P, mode, scal, wj, prev, j, Weights{wx, wy, wz},
                   Shard3d{}, w, partial, raw, nz, ny, nx, ss, st);
}

// pass1_shard3d: pass1_3d on one shard's (nz, ny, nx) block at global
// offsets (z0, y0, x0) of an (NZ, NY, NX) grid. mode: 0 iso reference, 1
// iso clean, 2 aniso (wx, wy, wz (R, nx), wxl (R), wyh (nz, nx), wzh
// (ny, nx); null otherwise). yh (P, 2, nz, nx), zh (P, 2, ny, nx), xh
// (P, 2, R): the halos. Otherwise as lz3_pass1.
int lz3_pass1_shard(int P, int mode, const float* scal, const float* wj,
                    const float* const* prev, int j, const float* wx,
                    const float* wy, const float* wz, const float* wxl,
                    const float* wyh, const float* wzh, const float* yh,
                    const float* zh, const float* xh, float* w,
                    float* partial, float* raw, int nz, int ny, int nx,
                    int z0, int y0, int x0, int NZ, int NY, int NX, float ss,
                    cudaStream_t st) {
  if ((P != 1 && P != 2) || mode < 0 || mode > 2 || j < 0
      || j + 1 > MAXCOLS || nz < 2 || ny < 2 || nx < 2 || !yh || !zh || !xh
      || z0 < 0 || y0 < 0 || x0 < 0 || z0 + nz > NZ || y0 + ny > NY
      || x0 + nx > NX)
    return (int)cudaErrorInvalidValue;
  if (mode == ANISO && (!wx || !wy || !wz || !wxl || !wyh || !wzh))
    return (int)cudaErrorInvalidValue;
  const Shard3d sh = {yh, zh, xh, wxl, wyh, wzh, z0, y0, x0, NZ, NY, NX};
  return pass1_any(P, SHARD_REF + mode, scal, wj, prev, j,
                   Weights{wx, wy, wz}, sh, w, partial, raw, nz, ny, nx, ss,
                   st);
}

// pass2. q: (nw, 2) device buffer. W: host array of nw = j+1 device
// pointers. n = R * nx points per plane. partial: scratch of
// lz3_pass2_blocks floats. nsq: 1 output.
int lz3_pass2(int P, const float* q, const float* w, const float* const* W,
              int nw, float* wn, float* partial, float* nsq, long long n,
              cudaStream_t st) {
  if ((P != 1 && P != 2) || nw < 1 || nw > MAXCOLS || n < 1)
    return (int)cudaErrorInvalidValue;
  const Cols c = make_cols(W, nw);
  const int b = bucket(nw);
  if (P == 1)
    launch_pass2<1>(b, q, w, c, nw, wn, partial, (size_t)n, st);
  else
    launch_pass2<2>(b, q, w, c, nw, wn, partial, (size_t)n, st);
  reduce_partials<<<1, RED_THREADS, 0, st>>>(partial, PASS2_BLOCKS, 1, nsq);
  return (int)cudaGetLastError();
}

// Number of blocks (= partial-sum rows) a pipe_3d launch uses.
int lz3_pipe3d_blocks(int nz, int ny, int nx) {
  const dim3 g = pipe3d_grid(nz, ny, nx);
  return (int)(g.x * g.y * g.z);
}

// pipe_3d (K8). mode as lz3_pass1. W: host array of nw = j+1 device
// pointers W_0..W_j. scal: (nw+1, 2) device buffer [(s_j, 0), c_0..c_j].
// partial: scratch of lz3_pipe3d_blocks * nout floats; red: nout outputs,
// nout = 1 + 2 nw + 2 (nw + 1) (nsq, gram, d).
int lz3_pipe3d(int P, int mode, const float* scal, const float* av,
               const float* const* W, int nw, const float* wx,
               const float* wy, const float* wz, float* wn, float* avn,
               float* partial, float* red, int nz, int ny, int nx, float ss,
               cudaStream_t st) {
  if ((P != 1 && P != 2) || mode < 0 || mode > 2 || nw < 1
      || nw + 1 > MAXCOLS || nz < 3 || ny < 3 || nx < 3)
    return (int)cudaErrorInvalidValue;
  if (mode == ANISO && (!wx || !wy || !wz)) return (int)cudaErrorInvalidValue;
  const Cols c = make_cols(W, nw);
  const Weights wt = {wx, wy, wz};
  const int b = bucket(nw);
  if (P == 1)
    pipe3d_mode<1>(mode, b, scal, av, c, nw, wt, wn, avn, partial, nz, ny, nx,
                   ss, st);
  else
    pipe3d_mode<2>(mode, b, scal, av, c, nw, wt, wn, avn, partial, nz, ny, nx,
                   ss, st);
  const int nout = 1 + 2 * nw + 2 * (nw + 1);
  reduce_partials<<<nout, RED_THREADS, 0, st>>>(
      partial, lz3_pipe3d_blocks(nz, ny, nx), nout, red);
  return (int)cudaGetLastError();
}

// bc3d: the ghost copy on the (P, nz*ny, nx) block u at global offsets
// (z0, y0, x0) of an (NZ, NY, NX) grid, in place (unsharded: offsets 0,
// the grid's shape). A block with no face cell launches nothing.
int lz3_bc3d(int P, float* u, int nz, int ny, int nx, int z0, int y0, int x0,
             int NZ, int NY, int NX, cudaStream_t st) {
  if ((P != 1 && P != 2) || nz < 2 || ny < 2 || nx < 2 || NZ < 3 || NY < 3
      || NX < 3 || z0 < 0 || y0 < 0 || x0 < 0 || z0 + nz > NZ
      || y0 + ny > NY || x0 + nx > NX)
    return (int)cudaErrorInvalidValue;
  const long long zl = z0 == 0, zh = z0 + nz == NZ, yl = y0 == 0;
  const long long yh = y0 + ny == NY, xl = x0 == 0, xh = x0 + nx == NX;
  const long long izn = nz - zl - zh, iyn = ny - yl - yh;
  const long long cells = (zl + zh) * ny * nx + (yl + yh) * izn * nx
                          + (xl + xh) * izn * iyn;
  if (cells == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((cells + 255) / 256);
  if (P == 1)
    bc3d_kernel<1><<<grid, 256, 0, st>>>(u, nz, ny, nx, z0, y0, x0, NZ, NY,
                                         NX);
  else
    bc3d_kernel<2><<<grid, 256, 0, st>>>(u, nz, ny, nx, z0, y0, x0, NZ, NY,
                                         NX);
  return (int)cudaGetLastError();
}

}  // extern "C"
