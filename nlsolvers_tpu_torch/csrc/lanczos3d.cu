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
//   bc3d     <- bc3d.py _bc_call (K14): the 6-face no-flux ghost copy
//
// The TPU split pass1 into y-slab and z-by-y brick kernels only to fit its
// blocks into VMEM; the function is the same, so here it is one kernel.
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
template <int P, int MAXW, int MODE>
__global__ void __launch_bounds__(TX) pass1_3d_kernel(
    const float* __restrict__ scal, const float* __restrict__ wj, Cols prev,
    const float* __restrict__ wjm1, int j, Weights wt,
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
        const float av = stencil3d<MODE>(b, wt, idx, r, z, y, x, R, nz, ny,
                                         nx, ss);
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
__device__ __forceinline__ int clamp_in(int v, int n) {
  return v == 0 ? 1 : (v == n - 1 ? n - 2 : v);
}

// One thread per face cell. The cells are enumerated without overlap: the
// two z faces (all y, x), then the two y faces on interior z (all x), then
// the two x faces on interior z and y.
template <int P>
__global__ void __launch_bounds__(256) bc3d_kernel(float* __restrict__ u,
                                                   int nz, int ny, int nx) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long zf = (long long)ny * nx;
  const long long yf = (long long)(nz - 2) * nx;
  const long long xf = (long long)(nz - 2) * (ny - 2);
  long long k = t;
  int z, y, x;
  if (k < 2 * zf) {
    z = k < zf ? 0 : nz - 1;
    k %= zf;
    y = (int)(k / nx);
    x = (int)(k % nx);
  } else if ((k -= 2 * zf) < 2 * yf) {
    y = k < yf ? 0 : ny - 1;
    k %= yf;
    z = 1 + (int)(k / nx);
    x = (int)(k % nx);
  } else if ((k -= 2 * yf) < 2 * xf) {
    x = k < xf ? 0 : nx - 1;
    k %= xf;
    z = 1 + (int)(k / (ny - 2));
    y = 1 + (int)(k % (ny - 2));
  } else {
    return;
  }
  const size_t plane = (size_t)nz * ny * nx;
  const size_t dst = ((size_t)z * ny + y) * nx + x;
  const size_t src = ((size_t)clamp_in(z, nz) * ny + clamp_in(y, ny)) * nx
                     + clamp_in(x, nx);
#pragma unroll
  for (int p = 0; p < P; ++p) u[p * plane + dst] = u[p * plane + src];
}

template <int P, int MAXW, int MODE>
void launch_pass1(const float* scal, const float* wj, Cols prev, int j,
                  Weights wt, float* w, float* partial, int nz, int ny,
                  int nx, float ss, cudaStream_t st) {
  pass1_3d_kernel<P, MAXW, MODE><<<tile_grid(nz * ny, nx), TX, 0, st>>>(
      scal, wj, prev, j > 0 ? prev.p[j - 1] : nullptr, j, wt, w, partial, nz,
      ny, nx, ss);
}

template <int P, int MODE>
void pass1_bucket(int b, const float* scal, const float* wj, Cols prev,
                  int j, Weights wt, float* w, float* partial, int nz, int ny,
                  int nx, float ss, cudaStream_t st) {
  if (b == 4)
    launch_pass1<P, 4, MODE>(scal, wj, prev, j, wt, w, partial, nz, ny, nx,
                             ss, st);
  else if (b == 8)
    launch_pass1<P, 8, MODE>(scal, wj, prev, j, wt, w, partial, nz, ny, nx,
                             ss, st);
  else if (b == 16)
    launch_pass1<P, 16, MODE>(scal, wj, prev, j, wt, w, partial, nz, ny, nx,
                              ss, st);
  else
    launch_pass1<P, 32, MODE>(scal, wj, prev, j, wt, w, partial, nz, ny, nx,
                              ss, st);
}

template <int P>
void pass1_mode(int mode, int b, const float* scal, const float* wj,
                Cols prev, int j, Weights wt, float* w, float* partial,
                int nz, int ny, int nx, float ss, cudaStream_t st) {
  if (mode == ISO_REF)
    pass1_bucket<P, ISO_REF>(b, scal, wj, prev, j, wt, w, partial, nz, ny,
                             nx, ss, st);
  else if (mode == ISO_CLEAN)
    pass1_bucket<P, ISO_CLEAN>(b, scal, wj, prev, j, wt, w, partial, nz, ny,
                               nx, ss, st);
  else
    pass1_bucket<P, ANISO>(b, scal, wj, prev, j, wt, w, partial, nz, ny, nx,
                           ss, st);
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
  const Cols c = make_cols(prev, j);
  const Weights wt = {wx, wy, wz};
  const int b = bucket(j);
  if (P == 1)
    pass1_mode<1>(mode, b, scal, wj, c, j, wt, w, partial, nz, ny, nx, ss,
                  st);
  else
    pass1_mode<2>(mode, b, scal, wj, c, j, wt, w, partial, nz, ny, nx, ss,
                  st);
  const int nout = 2 * (j + 1);
  reduce_partials<<<nout, RED_THREADS, 0, st>>>(
      partial, lz3_pass1_blocks(nz, ny, nx), nout, raw);
  return (int)cudaGetLastError();
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

// bc3d: the ghost copy on the (P, nz*ny, nx) field u, in place.
int lz3_bc3d(int P, float* u, int nz, int ny, int nx, cudaStream_t st) {
  if ((P != 1 && P != 2) || nz < 3 || ny < 3 || nx < 3)
    return (int)cudaErrorInvalidValue;
  const long long cells = 2LL * ny * nx + 2LL * (nz - 2) * nx
                          + 2LL * (nz - 2) * (ny - 2);
  const unsigned grid = (unsigned)((cells + 255) / 256);
  if (P == 1)
    bc3d_kernel<1><<<grid, 256, 0, st>>>(u, nz, ny, nx);
  else
    bc3d_kernel<2><<<grid, 256, 0, st>>>(u, nz, ny, nx);
  return (int)cudaGetLastError();
}

}  // extern "C"
