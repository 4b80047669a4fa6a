// Hand-written Hopper (sm_90a) kernels for the two-pass 3D Lanczos
// matrix-function loop and the 3D no-flux ghost copy.
//
// Replaces these Pallas TPU kernels of nlsolvers_tpu/ops/pallas/:
//   pass1_3d <- lanczos3d_pipe.py _pass1y_call (K6) and _pass1zy_call (K7),
//               and lanczos2d.py _pass1_call in modes iso3d/aniso3d (K1'):
//        w = s_j A(W_j) - bs W_{j-1}, fused with raw_i = <W_i, w>, i <= j
//   pass2    <- lanczos2d.py _pass2_call (K4):
//        w' = w - sum_{i<=j} q_i W_i (complex q_i), fused with ||w'||^2
//   bc3d     <- bc3d.py _bc_call (K14): the 6-face no-flux ghost copy
//
// The TPU split pass1 into y-slab and z-by-y brick kernels only to fit its
// blocks into VMEM; the function is the same, so here it is one kernel.
//
// Fields are planar float32 (P, R, nx) on the merged row view R = nz * ny:
// a grid point (z, y, x) is row r = z * ny + y. On that view the x
// neighbours are +-1 column, the y neighbours +-1 row and the z neighbours
// +-ny rows. The operator modes:
//   ISO_REF    7-point Laplacian of the reference (laplacians.hpp:105-156):
//              y neighbours are the plain merged rows, so row (z, ny-1)
//              couples to (z+1, 0) (the reference's y-seam); diagonal -5 on
//              any boundary cell, -6 inside.
//   ISO_CLEAN  y neighbours only inside a plane; diagonal -(neighbours).
//   ANISO      finite-volume div(c grad u) with zero-padded face weights
//              wx, wy, wz, each (R, nx) (ops/operators.py): all boundary and
//              seam structure is in the weights.
//
// What bounds them on an H100: bytes streamed from device memory; the
// arithmetic is a few flops per loaded float. pass1 at iteration j reads
// j + 1 columns and writes 1 (plus three weight planes for ANISO), pass2
// reads j + 2 and writes 1. At 128^3 complex64 a column is 16.8 MB.
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
// * bc3d writes only the faces, in place. With the reference's order (x
//   faces on interior y and z, then y faces on interior z, then z faces)
//   every face cell ends up holding u(clamp(z), clamp(y), clamp(x)), where
//   clamp maps 0 to 1 and n-1 to n-2: an interior cell that no thread
//   writes, so one kernel does the whole copy without a race. Its bytes are
//   the faces', not the volume's.
// * Scalars (s_j, bs, q_i) are read from a device buffer, and the
//   reductions are two-stage and deterministic (lz_common.cuh).
//
// Plain C interface for ctypes: every launcher returns cudaGetLastError().

#include "lz_common.cuh"

namespace {

enum Mode { ISO_REF = 0, ISO_CLEAN = 1, ANISO = 2 };

// Blocks of the pass2 grid-stride loop: about 16 blocks of TX threads on
// each of the H100's 132 SMs.
constexpr int PASS2_BLOCKS = 132 * 16;

struct Weights { const float* wx; const float* wy; const float* wz; };

// The operator at merged row r = z ny + y, column x, of one plane b.
template <int MODE>
__device__ __forceinline__ float stencil3d(const float* __restrict__ b,
                                           const Weights& wt, size_t idx,
                                           int r, int z, int y, int x,
                                           int R, int nz, int ny, int nx,
                                           float ss) {
  const size_t zoff = (size_t)ny * nx;
  const float cv = __ldg(b + idx);
  if (MODE == ANISO) {
    const float rt = x < nx - 1 ? __ldg(b + idx + 1) : 0.0f;
    const float fx = __ldg(wt.wx + idx) * (rt - cv);
    const float fx_l =
        x > 0 ? __ldg(wt.wx + idx - 1) * (cv - __ldg(b + idx - 1)) : 0.0f;
    const float dn = r < R - 1 ? __ldg(b + idx + nx) : 0.0f;
    const float fy = __ldg(wt.wy + idx) * (dn - cv);
    const float fy_m1 =
        r > 0 ? __ldg(wt.wy + idx - nx) * (cv - __ldg(b + idx - nx)) : 0.0f;
    const float zd = z < nz - 1 ? __ldg(b + idx + zoff) : 0.0f;
    const float fz = __ldg(wt.wz + idx) * (zd - cv);
    const float fz_m =
        z > 0 ? __ldg(wt.wz + idx - zoff) * (cv - __ldg(b + idx - zoff))
              : 0.0f;
    return (fx - fx_l + fy - fy_m1 + fz - fz_m) * ss;
  }
  const bool has_up = MODE == ISO_REF ? r > 0 : y > 0;
  const bool has_dn = MODE == ISO_REF ? r < R - 1 : y < ny - 1;
  const float up = has_up ? __ldg(b + idx - nx) : 0.0f;
  const float dn = has_dn ? __ldg(b + idx + nx) : 0.0f;
  const float zu = z > 0 ? __ldg(b + idx - zoff) : 0.0f;
  const float zd = z < nz - 1 ? __ldg(b + idx + zoff) : 0.0f;
  const float lf = x > 0 ? __ldg(b + idx - 1) : 0.0f;
  const float rt = x < nx - 1 ? __ldg(b + idx + 1) : 0.0f;
  const int zb0 = z == 0, zb1 = z == nz - 1, yb0 = y == 0, yb1 = y == ny - 1;
  const int xb0 = x == 0, xb1 = x == nx - 1;
  float diag;
  if (MODE == ISO_REF)
    diag = (zb0 | zb1 | yb0 | yb1 | xb0 | xb1) ? -5.0f : -6.0f;
  else
    diag = -(6.0f - (float)(zb0 + zb1 + yb0 + yb1 + xb0 + xb1));
  return (up + dn + zu + zd + lf + rt + diag * cv) * ss;
}

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
