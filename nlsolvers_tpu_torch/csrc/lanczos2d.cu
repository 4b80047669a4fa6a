// Hand-written Hopper (sm_90a) kernels for the pipelined 2D Lanczos
// matrix-function loop on the 5-point no-flux Laplacian ("iso2d").
//
// Replaces three Pallas TPU kernels of nlsolvers_tpu/ops/pallas/lanczos2d.py:
//   K1 pass1_iso2d   <- _pass1_call, mode "iso2d"
//        w = s_j A(W_j) - bs W_{j-1}, fused with raw_i = <W_i, w>, i <= j
//   K2 pipe_iso2d    <- _pipe_call, mode "iso2d"
//        W_{j+1} = s av_j - sum_i c_i W_i (complex c_i), ||W_{j+1}||^2,
//        gram_i = <W_i, W_{j+1}>; unless LAST also av_{j+1} = A(W_{j+1}),
//        d_i = <W_i, av_{j+1}> (i <= j) and d_{j+1} = <W_{j+1}, av_{j+1}>
//   K3 combine       <- _combine_call
//        y_spec = sum_i q[spec, i] W_i for k specs in one pass
//
// Fields are planar float32 (P, ny, nx); the block shape, the dot and the
// reduction are in lz_common.cuh.
//
// What bounds them on an H100: bytes streamed from device memory. The
// arithmetic is a few flops per loaded float. K2 at iteration j reads j+2
// columns (av_j, W_0..W_j) and writes 2 (W_{j+1}, av_{j+1}); at 1024^2
// complex64 a column is 8 MB, so K2 at j = 8 moves ~88 MB. K1 reads j+1
// columns and writes 1; K3 reads m and writes k.
//
// What the design does about it:
// * Every column is read from device memory once per launch. A block owns a
//   TY x TX tile and walks it row by row; the second and third touches of a
//   value (a dot after the reconstruction, a stencil neighbour) come one row
//   step later from L1/L2, not from DRAM.
// * K2 needs the stencil of the column it is building. It rebuilds W_{j+1}
//   on the tile's halo rows and columns from av_j and the W_i, read straight
//   from global memory, with the same coefficients, and keeps a 3-row ring
//   of W_{j+1} in shared memory for the stencil. No halo arrays are built.
// * The diagonal of the stencil is computed from the row/column index, so it
//   costs no traffic.
// * Scalars (s_j, bs, c_i, q) are read from a device buffer, so no host sync
//   is needed between the scalar recurrence and the kernels.
// * Cross-block reductions are two-stage and deterministic, with no
//   atomics (reduce_partials, lz_common.cuh).
//
// Plain C interface for ctypes: every launcher returns cudaGetLastError().

#include "lz_common.cuh"

namespace {

constexpr int KMAX = 4;        // most specs one combine launch takes

struct Outs { float* p[KMAX]; };

// Variant diagonal: "reference" is -3 on the whole boundary ring (corners
// included) and -4 inside; "clean" is -(number of existing neighbours).
__device__ __forceinline__ float stencil_diag(int r, int x, int ny, int nx,
                                              int clean) {
  const int top = r == 0, bot = r == ny - 1, lft = x == 0, rgt = x == nx - 1;
  if (clean) return -(4.0f - top - bot - lft - rgt);
  return (top | bot | lft | rgt) ? -3.0f : -4.0f;
}

// ---------------------------------------------------------------- K1 pass1
// MAXW bounds j (the number of earlier columns) so the per-column
// accumulators stay in registers.
template <int P, int MAXW>
__global__ void __launch_bounds__(TX) pass1_iso2d_kernel(
    const float* __restrict__ scal, const float* __restrict__ wj, Cols prev,
    const float* __restrict__ wjm1, int j, float* __restrict__ w_out,
    float* __restrict__ partial, int ny, int nx, float ss, int clean) {
  __shared__ float red[NWARP][RED_W];
  const int t = threadIdx.x;
  const int x = blockIdx.x * TX + t;
  const int y0 = blockIdx.y * TY;
  const int rows = min(TY, ny - y0);
  const size_t plane = (size_t)ny * nx;
  const float s = scal[0], bs = scal[1];

  float acc[MAXW][2] = {};
  float accj[2] = {0.0f, 0.0f};
  if (x < nx) {
    for (int rr = 0; rr < rows; ++rr) {
      const int r = y0 + rr;
      const size_t idx = (size_t)r * nx + x;
      const float diag = stencil_diag(r, x, ny, nx, clean);
      float c[P], w[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* __restrict__ b = wj + p * plane;
        const float cv = __ldg(b + idx);
        const float up = r > 0 ? __ldg(b + idx - nx) : 0.0f;
        const float dn = r < ny - 1 ? __ldg(b + idx + nx) : 0.0f;
        const float lf = x > 0 ? __ldg(b + idx - 1) : 0.0f;
        const float rt = x < nx - 1 ? __ldg(b + idx + 1) : 0.0f;
        const float av = (up + dn + lf + rt + diag * cv) * ss;
        float wv = s * av;
        if (j > 0) wv = wv - bs * __ldg(wjm1 + p * plane + idx);
        c[p] = cv;
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

// ---------------------------------------------------------------- K2 pipe
// W_{j+1} at one point from av_j and W_0..W_j (same operation order as the
// Pallas kernel's reconstruction).
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

// MAXW bounds nw = j + 1, the number of basis columns.
template <int P, int MAXW, bool LAST>
__global__ void __launch_bounds__(TX) pipe_iso2d_kernel(
    const float* __restrict__ scal, const float* __restrict__ av, Cols W,
    int nw, float* __restrict__ wn_out, float* __restrict__ av_out,
    float* __restrict__ partial, int ny, int nx, float ss, int clean) {
  __shared__ float red[NWARP][RED_W];
  __shared__ float ring[LAST ? 1 : 3][P][TX + 2];
  const int t = threadIdx.x;
  const int x0 = blockIdx.x * TX;
  const int x = x0 + t;
  const bool xin = x < nx;
  const int y0 = blockIdx.y * TY;
  const int rows = min(TY, ny - y0);
  const size_t plane = (size_t)ny * nx;

  const float s = scal[0];
  float cf[MAXW][2];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    cf[i][0] = i < nw ? scal[2 + 2 * i] : 0.0f;
    cf[i][1] = i < nw ? scal[3 + 2 * i] : 0.0f;
  }

  float nsq = 0.0f;
  float g[MAXW][2] = {};
  float d[MAXW][2] = {};
  float dl[2] = {0.0f, 0.0f};     // d_{j+1} = <W_{j+1}, av_{j+1}>

  // Step rr rebuilds row y0-1+rr (a halo row when rr == 0 or rr == rows+1)
  // and, once three ring rows exist, stencils row y0-2+rr.
  const int first = LAST ? 1 : 0;
  const int stop = LAST ? rows : rows + 1;
  for (int rr = first; rr <= stop; ++rr) {
    const int r = y0 - 1 + rr;
    const bool tile_row = rr >= 1 && rr <= rows;
    float v[P];
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = 0.0f;   // out of grid: zero
    if (r >= 0 && r < ny && xin)
      rebuild<P, MAXW>(av, W, nw, s, cf, (size_t)r * nx + x, plane, v);
    if (tile_row && xin) {
      const size_t idx = (size_t)r * nx + x;
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
    if (LAST) continue;

    const int slot = rr % 3;
#pragma unroll
    for (int p = 0; p < P; ++p) ring[slot][p][t + 1] = v[p];
    if (t < 2 && tile_row) {       // halo columns x0-1 and x0+TX
      const int hx = t == 0 ? x0 - 1 : x0 + TX;
      float h[P];
#pragma unroll
      for (int p = 0; p < P; ++p) h[p] = 0.0f;
      if (hx >= 0 && hx < nx)
        rebuild<P, MAXW>(av, W, nw, s, cf, (size_t)r * nx + hx, plane, h);
#pragma unroll
      for (int p = 0; p < P; ++p) ring[slot][p][t == 0 ? 0 : TX + 1] = h[p];
    }
    __syncthreads();
    if (rr >= 2 && xin) {
      const int rs = r - 1;            // a tile row: y0 <= rs < y0 + rows
      const int sc = (rr - 1) % 3, su = (rr - 2) % 3;
      const size_t idx = (size_t)rs * nx + x;
      const float diag = stencil_diag(rs, x, ny, nx, clean);
      float a[P], c[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        c[p] = ring[sc][p][t + 1];
        a[p] = (ring[su][p][t + 1] + ring[slot][p][t + 1] + ring[sc][p][t]
                + ring[sc][p][t + 2] + diag * c[p]) * ss;
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
    __syncthreads();                   // ring slot is rewritten next step
  }

  // partial layout: nsq | gram_i (re, im), i < nw | d_i (re, im), i <= nw
  put(red, 0, nsq);
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i < nw) {
      put(red, 1 + 2 * i, g[i][0]);
      put(red, 2 + 2 * i, g[i][1]);
    }
  }
  int nout = 1 + 2 * nw;
  if (!LAST) {
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      if (i < nw) {
        put(red, nout + 2 * i, d[i][0]);
        put(red, nout + 2 * i + 1, d[i][1]);
      }
    }
    put(red, nout + 2 * nw, dl[0]);
    put(red, nout + 2 * nw + 1, dl[1]);
    nout += 2 * (nw + 1);
  }
  write_partials(red, nout, partial);
}

// ---------------------------------------------------------------- K3 combine
template <int P>
__global__ void __launch_bounds__(256) combine_kernel(
    const float* __restrict__ q, Cols W, int m, int k, Outs out, size_t n) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float y[KMAX][2] = {};
#pragma unroll
  for (int i = 0; i < MAXCOLS; ++i) {
    if (i < m) {
      float w[2];
      w[0] = __ldg(W.p[i] + e);
      w[1] = P == 2 ? __ldg(W.p[i] + n + e) : 0.0f;
#pragma unroll
      for (int sp = 0; sp < KMAX; ++sp) {
        if (sp < k) {
          const float a = __ldg(q + 2 * (sp * m + i));
          const float b = __ldg(q + 2 * (sp * m + i) + 1);
          if (P == 1) {
            y[sp][0] = i == 0 ? a * w[0] : y[sp][0] + a * w[0];
          } else if (i == 0) {
            y[sp][0] = a * w[0] - b * w[1];
            y[sp][1] = a * w[1] + b * w[0];
          } else {
            y[sp][0] = y[sp][0] + a * w[0] - b * w[1];
            y[sp][1] = y[sp][1] + a * w[1] + b * w[0];
          }
        }
      }
    }
  }
#pragma unroll
  for (int sp = 0; sp < KMAX; ++sp) {
    if (sp < k) {
      out.p[sp][e] = y[sp][0];
      if (P == 2) out.p[sp][n + e] = y[sp][1];
    }
  }
}

template <int P, int MAXW>
void launch_pass1(const float* scal, const float* wj, Cols prev, int j,
                  float* w, float* partial, int ny, int nx, float ss,
                  int clean, cudaStream_t st) {
  pass1_iso2d_kernel<P, MAXW><<<tile_grid(ny, nx), TX, 0, st>>>(
      scal, wj, prev, j > 0 ? prev.p[j - 1] : nullptr, j, w, partial, ny, nx,
      ss, clean);
}

template <int P, int MAXW>
void launch_pipe(bool last, const float* scal, const float* av, Cols W,
                 int nw, float* wn, float* avn, float* partial, int ny,
                 int nx, float ss, int clean, cudaStream_t st) {
  if (last)
    pipe_iso2d_kernel<P, MAXW, true><<<tile_grid(ny, nx), TX, 0, st>>>(
        scal, av, W, nw, wn, avn, partial, ny, nx, ss, clean);
  else
    pipe_iso2d_kernel<P, MAXW, false><<<tile_grid(ny, nx), TX, 0, st>>>(
        scal, av, W, nw, wn, avn, partial, ny, nx, ss, clean);
}

}  // namespace

extern "C" {

// Number of blocks (= partial-sum rows) the K1/K2 launches use.
int lz_num_blocks(int ny, int nx) {
  const dim3 g = tile_grid(ny, nx);
  return (int)(g.x * g.y);
}

int lz_max_cols() { return MAXCOLS; }
const char* lz_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
int lz_max_specs() { return KMAX; }

// K1. prev: host array of j device pointers W_0..W_{j-1}. partial: scratch
// of lz_num_blocks * 2(j+1) floats. raw: (j+1, 2) output.
int lz_pass1_iso2d(int P, const float* scal, const float* wj,
                   const float* const* prev, int j, float* w, float* partial,
                   float* raw, int ny, int nx, float ss, int clean,
                   cudaStream_t st) {
  if ((P != 1 && P != 2) || j < 0 || j + 1 > MAXCOLS || ny < 3 || nx < 3)
    return (int)cudaErrorInvalidValue;
  const Cols c = make_cols(prev, j);
  const int b = bucket(j);
#define LZ_P1(PP, BB) launch_pass1<PP, BB>(scal, wj, c, j, w, partial, ny, \
                                           nx, ss, clean, st)
  if (P == 1) {
    if (b == 4) LZ_P1(1, 4); else if (b == 8) LZ_P1(1, 8);
    else if (b == 16) LZ_P1(1, 16); else LZ_P1(1, 32);
  } else {
    if (b == 4) LZ_P1(2, 4); else if (b == 8) LZ_P1(2, 8);
    else if (b == 16) LZ_P1(2, 16); else LZ_P1(2, 32);
  }
#undef LZ_P1
  const int nout = 2 * (j + 1);
  reduce_partials<<<nout, RED_THREADS, 0, st>>>(partial, lz_num_blocks(ny, nx),
                                                nout, raw);
  return (int)cudaGetLastError();
}

// K2. W: host array of nw = j+1 device pointers W_0..W_j. scal: (nw+1, 2)
// device buffer [(s_j, 0), c_0..c_j]. partial: scratch of lz_num_blocks *
// nout floats; red: nout outputs, nout = 1 + 2nw (+ 2(nw+1) unless last).
int lz_pipe_iso2d(int P, int last, const float* scal, const float* av,
                  const float* const* W, int nw, float* wn, float* avn,
                  float* partial, float* red, int ny, int nx, float ss,
                  int clean, cudaStream_t st) {
  if ((P != 1 && P != 2) || nw < 1 || nw + 1 > MAXCOLS || ny < 3 || nx < 3)
    return (int)cudaErrorInvalidValue;
  const Cols c = make_cols(W, nw);
  const int b = bucket(nw);
  const bool l = last != 0;
#define LZ_PI(PP, BB) launch_pipe<PP, BB>(l, scal, av, c, nw, wn, avn, \
                                          partial, ny, nx, ss, clean, st)
  if (P == 1) {
    if (b == 4) LZ_PI(1, 4); else if (b == 8) LZ_PI(1, 8);
    else if (b == 16) LZ_PI(1, 16); else LZ_PI(1, 32);
  } else {
    if (b == 4) LZ_PI(2, 4); else if (b == 8) LZ_PI(2, 8);
    else if (b == 16) LZ_PI(2, 16); else LZ_PI(2, 32);
  }
#undef LZ_PI
  const int nout = 1 + 2 * nw + (l ? 0 : 2 * (nw + 1));
  reduce_partials<<<nout, RED_THREADS, 0, st>>>(partial, lz_num_blocks(ny, nx),
                                                nout, red);
  return (int)cudaGetLastError();
}

// K3. q: (k, m, 2) device buffer. W: host array of m device pointers.
// outs: host array of k device pointers to (P, ny, nx) outputs.
int lz_combine(int P, const float* q, const float* const* W, int m, int k,
               float* const* outs, int ny, int nx, cudaStream_t st) {
  if ((P != 1 && P != 2) || m < 1 || m > MAXCOLS || k < 1 || k > KMAX)
    return (int)cudaErrorInvalidValue;
  const Cols c = make_cols(W, m);
  Outs o = {};
  for (int i = 0; i < k; ++i) o.p[i] = outs[i];
  const size_t n = (size_t)ny * nx;
  const unsigned grid = (unsigned)((n + 255) / 256);
  if (P == 1)
    combine_kernel<1><<<grid, 256, 0, st>>>(q, c, m, k, o, n);
  else
    combine_kernel<2><<<grid, 256, 0, st>>>(q, c, m, k, o, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
