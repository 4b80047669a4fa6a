// Hand-written Hopper (sm_90a) kernels for the pipelined 2D Lanczos
// matrix-function loop, on two stencil operators: the 5-point no-flux
// Laplacian ("iso2d") and the finite-volume div(c grad u) with zero-padded
// face weights wx, wy ("aniso2d").
//
// Replaces four Pallas TPU kernels of nlsolvers_tpu/ops/pallas/lanczos2d.py:
//   K1 / K1' pass1_iso2d, pass1_aniso2d <- _pass1_call, modes iso2d, aniso2d
//        w = s_j A(W_j) - bs W_{j-1}, fused with raw_i = <W_i, w>, i <= j
//   K2 / K2' pipe_iso2d, pipe_aniso2d   <- _pipe_call, modes iso2d, aniso2d
//        W_{j+1} = s av_j - sum_i c_i W_i (complex c_i), ||W_{j+1}||^2,
//        gram_i = <W_i, W_{j+1}>; unless LAST also av_{j+1} = A(W_{j+1}),
//        d_i = <W_i, av_{j+1}> (i <= j) and d_{j+1} = <W_{j+1}, av_{j+1}>
//   K3 combine                          <- _combine_call
//        y_spec = sum_i q[spec, i] W_i for k specs in one pass
//   K5 iter_step (lz_iter)              <- _iter_call, modes iso2d, aniso2d,
//        iso3d: pass1 and pass2 of iteration j in one cooperative launch,
//        the opt-in fused iteration (the phase bodies are lz_iter.cuh's)
//   K1' pass1_shard2d                   <- _pass1_call, modes shard2d,
//        shard2d_aniso: K1 on one shard's block of a sharded grid, the
//        shard policies OP_SHARD_ISO / OP_SHARD_ANISO of the same kernel
//        (halos from the neighbour shards, read by the edge threads only;
//        the diagonal from global coordinates; lz_stencil.cuh)
//
// Fields are planar float32 (P, ny, nx); the block shape, the dot and the
// reduction are in lz_common.cuh, the operators in lz_stencil.cuh. The
// operator is a template policy (OP) of
// one pass1 and one pipe kernel: both stencils read the same five values of
// u per cell, so the tiling, the halo rebuild and the dots are shared; the
// aniso stencil adds four weight loads per cell (wx at x and x-1, wy at r
// and r-1), which read the same two weight planes one column or one row
// apart and so come from L1/L2 after the first touch. The LAST pipe
// iteration computes no stencil and reads no weights, in both modes.
//
// What bounds them on an H100: bytes streamed from device memory. The
// arithmetic is a few flops per loaded float. K2 at iteration j reads j+2
// columns (av_j, W_0..W_j) and writes 2 (W_{j+1}, av_{j+1}); at 1024^2
// complex64 a column is 8 MB, so K2 at j = 8 moves ~88 MB (aniso: two
// 4 MB weight planes more). K1 reads j+1 columns and writes 1; K3 reads m
// and writes k.
//
// K5 at iteration j reads W_0..W_j (twice: for the dots, then for the
// subtraction) and writes w and W_{j+1}; w (8.4 MB at 1024^2) is written
// in phase 0 and read back in phase 1, mostly from the 50 MB L2.
//
// What the design does about it:
// * Every column is read from device memory once per launch. A block owns a
//   TY x TX tile and walks it row by row; the second and third touches of a
//   value (a dot after the reconstruction, a stencil neighbour) come one row
//   step later from L1/L2, not from DRAM.
// * K2 needs the stencil of the column it is building. It rebuilds W_{j+1}
//   on the tile's halo rows and columns from av_j and the W_i, read straight
//   from global memory, with the same coefficients, and keeps a 3-row ring
//   of W_{j+1} in shared memory for the stencil. No halo arrays are built;
//   the aniso weights of the halo faces are read from global memory too.
// * The iso diagonal is computed from the row/column index, so it costs no
//   traffic.
// * Scalars (s_j, bs, c_i, q) are read from a device buffer, so no host sync
//   is needed between the scalar recurrence and the kernels.
// * Cross-block reductions are two-stage and deterministic, with no
//   atomics (reduce_partials, lz_common.cuh).
//
// Plain C interface for ctypes: every launcher returns cudaGetLastError().

#include "lz_common.cuh"
#include "lz_iter.cuh"
#include "lz_stencil.cuh"

namespace {

constexpr int KMAX = 4;        // most specs one combine launch takes
struct Outs { float* p[KMAX]; };

// ---------------------------------------------------------------- K1 pass1
// MAXW bounds j (the number of earlier columns) so the per-column
// accumulators stay in registers.
// The shard policies take their halos, offsets and edge face weights from
// sh (unused otherwise).
template <int P, int MAXW, int OP>
__global__ void __launch_bounds__(TX) pass1_2d_kernel(
    const float* __restrict__ scal, const float* __restrict__ wj, Cols prev,
    const float* __restrict__ wjm1, int j, Op2d op, Shard2d sh,
    float* __restrict__ w_out, float* __restrict__ partial, int ny, int nx,
    float ss) {
  constexpr bool SHARD = OP == OP_SHARD_ISO || OP == OP_SHARD_ANISO;
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
      float k[4];
      if constexpr (SHARD)
        load_coef_shard<OP>(op, sh, r, x, nx, idx, k);
      else
        load_coef<OP>(op, r, x, ny, nx, idx, k);
      float c[P], w[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* __restrict__ b = wj + p * plane;
        const float cv = __ldg(b + idx);
        float up, dn, lf, rt;
        if constexpr (SHARD) {
          neighbours_shard2d(b, sh, p, idx, r, x, ny, nx, up, dn, lf, rt);
        } else {
          up = r > 0 ? __ldg(b + idx - nx) : 0.0f;
          dn = r < ny - 1 ? __ldg(b + idx + nx) : 0.0f;
          lf = x > 0 ? __ldg(b + idx - 1) : 0.0f;
          rt = x < nx - 1 ? __ldg(b + idx + 1) : 0.0f;
        }
        const float av = stencil<OP>(cv, up, dn, lf, rt, r, x, k) * ss;
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
// MAXW bounds nw = j + 1, the number of basis columns. LAST computes no
// stencil, so its one instantiation (OP_ISO) serves both operators.
template <int P, int MAXW, bool LAST, int OP>
__global__ void __launch_bounds__(TX) pipe_2d_kernel(
    const float* __restrict__ scal, const float* __restrict__ av, Cols W,
    int nw, Op2d op, float* __restrict__ wn_out, float* __restrict__ av_out,
    float* __restrict__ partial, int ny, int nx, float ss) {
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
      float k[4];
      load_coef<OP>(op, rs, x, ny, nx, idx, k);
      float a[P], c[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        c[p] = ring[sc][p][t + 1];
        a[p] = stencil<OP>(c[p], ring[su][p][t + 1], ring[slot][p][t + 1],
                           ring[sc][p][t], ring[sc][p][t + 2], rs, x, k) * ss;
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

// ---------------------------------------------------------------- K5 iter
// One whole iteration j in one cooperative launch: phase_w, a grid sync,
// every block sums the raw dots and forms q_i = s_i^2 raw_i itself,
// phase_sub, a grid sync, and block 0 writes raw and ||W_{j+1}||^2.
// scal: (j+3) [s_j, bs, s_0..s_j]. w: the (P, rows, nx) scratch that holds
// w between the phases. part_a / part_b: partial-sum rows of the two phases.
template <int P, int MAXW, int OPK>
__global__ void __launch_bounds__(CT) iter_kernel(
    const float* __restrict__ scal, const float* __restrict__ wj, Cols prev,
    int j, OpArgs a, float* w, float* __restrict__ wn_out, float* part_a,
    float* part_b, float* __restrict__ raw_out, float* __restrict__ nsq_out) {
  __shared__ float red[CWARP][RED_W];
  __shared__ float rs[2 * MAXCOLS];
  cg::grid_group grid = cg::this_grid();
  const ColList W = {prev, wj, j};
  const size_t n = (size_t)a.nz * a.ny * a.nx;
  phase_w<P, MAXW, OPK, LdNC>(scal[0], scal[1], W, j, a, w, red, part_a);
  grid.sync();
  reduce_all(part_a, 2 * (j + 1), rs);
  if (blockIdx.x == 0)
    for (int o = threadIdx.x; o < 2 * (j + 1); o += CT) raw_out[o] = rs[o];
  phase_sub<P, MAXW, LdNC>(W, j, scal + 2, rs, n, w, wn_out, red, part_b);
  grid.sync();
  if (blockIdx.x == 0) {
    reduce_all(part_b, 1, rs);
    if (threadIdx.x == 0) nsq_out[0] = rs[0];
  }
}

// The grid of one iter_kernel instantiation, found once.
template <int P, int MAXW, int OPK>
int iter_grid() {
  static const int g = coop_blocks(iter_kernel<P, MAXW, OPK>);
  return g;
}

template <int P, int MAXW, int OPK>
int launch_iter(const float* scal, const float* wj, Cols prev, int j,
                OpArgs a, float* w, float* wn, float* part_a, float* part_b,
                float* raw, float* nsq, cudaStream_t st) {
  void* args[] = {&scal, &wj, &prev, &j, &a, &w, &wn, &part_a, &part_b,
                  &raw, &nsq};
  return coop_launch(iter_kernel<P, MAXW, OPK>, iter_grid<P, MAXW, OPK>(),
                     args, st);
}

template <int P, int OPK>
int iter_bucket(int b, const float* scal, const float* wj, Cols prev, int j,
                OpArgs a, float* w, float* wn, float* part_a, float* part_b,
                float* raw, float* nsq, cudaStream_t st) {
#define LZ_IT(BB) launch_iter<P, BB, OPK>(scal, wj, prev, j, a, w, wn, \
                                          part_a, part_b, raw, nsq, st)
  if (b == 4) return LZ_IT(4);
  if (b == 8) return LZ_IT(8);
  if (b == 16) return LZ_IT(16);
  return LZ_IT(32);
#undef LZ_IT
}

template <int P>
int iter_op(int opk, int b, const float* scal, const float* wj, Cols prev,
            int j, OpArgs a, float* w, float* wn, float* part_a,
            float* part_b, float* raw, float* nsq, cudaStream_t st) {
#define LZ_OP(OO) iter_bucket<P, OO>(b, scal, wj, prev, j, a, w, wn, part_a, \
                                     part_b, raw, nsq, st)
  if (opk == OPK_ISO2D) return LZ_OP(OPK_ISO2D);
  if (opk == OPK_ANISO2D) return LZ_OP(OPK_ANISO2D);
  if (opk == OPK_ISO3D_REF) return LZ_OP(OPK_ISO3D_REF);
  return LZ_OP(OPK_ISO3D_CLEAN);
#undef LZ_OP
}

template <int P, int MAXW, int OP>
void launch_pass1(const float* scal, const float* wj, Cols prev, int j,
                  const Op2d& op, const Shard2d& sh, float* w, float* partial,
                  int ny, int nx, float ss, cudaStream_t st) {
  pass1_2d_kernel<P, MAXW, OP><<<tile_grid(ny, nx), TX, 0, st>>>(
      scal, wj, prev, j > 0 ? prev.p[j - 1] : nullptr, j, op, sh, w, partial,
      ny, nx, ss);
}

template <int P, int MAXW, int OP>
void launch_pipe(bool last, const float* scal, const float* av, Cols W,
                 int nw, const Op2d& op, float* wn, float* avn,
                 float* partial, int ny, int nx, float ss, cudaStream_t st) {
  if (last)
    pipe_2d_kernel<P, MAXW, true, OP_ISO><<<tile_grid(ny, nx), TX, 0, st>>>(
        scal, av, W, nw, op, wn, avn, partial, ny, nx, ss);
  else
    pipe_2d_kernel<P, MAXW, false, OP><<<tile_grid(ny, nx), TX, 0, st>>>(
        scal, av, W, nw, op, wn, avn, partial, ny, nx, ss);
}

int num_blocks(int ny, int nx) {
  const dim3 g = tile_grid(ny, nx);
  return (int)(g.x * g.y);
}

// K1 / K1' with the operator OP, then the reduction of its partial sums.
// A shard's block may have sides of 2 (its halos hold the neighbours).
template <int OP>
int pass1_2d(int P, const float* scal, const float* wj,
             const float* const* prev, int j, const Op2d& op,
             const Shard2d& sh, float* w, float* partial, float* raw, int ny,
             int nx, float ss, cudaStream_t st) {
  const int lo = OP == OP_SHARD_ISO || OP == OP_SHARD_ANISO ? 2 : 3;
  if ((P != 1 && P != 2) || j < 0 || j + 1 > MAXCOLS || ny < lo || nx < lo)
    return (int)cudaErrorInvalidValue;
  const Cols c = make_cols(prev, j);
  const int b = bucket(j);
#define LZ_P1(PP, BB) launch_pass1<PP, BB, OP>(scal, wj, c, j, op, sh, w, \
                                               partial, ny, nx, ss, st)
  if (P == 1) {
    if (b == 4) LZ_P1(1, 4); else if (b == 8) LZ_P1(1, 8);
    else if (b == 16) LZ_P1(1, 16); else LZ_P1(1, 32);
  } else {
    if (b == 4) LZ_P1(2, 4); else if (b == 8) LZ_P1(2, 8);
    else if (b == 16) LZ_P1(2, 16); else LZ_P1(2, 32);
  }
#undef LZ_P1
  const int nout = 2 * (j + 1);
  reduce_partials<<<nout, RED_THREADS, 0, st>>>(partial, num_blocks(ny, nx),
                                                nout, raw);
  return (int)cudaGetLastError();
}

// K2 / K2' with the operator OP, then the reduction of its partial sums.
template <int OP>
int pipe_2d(int P, int last, const float* scal, const float* av,
            const float* const* W, int nw, const Op2d& op, float* wn,
            float* avn, float* partial, float* red, int ny, int nx, float ss,
            cudaStream_t st) {
  if ((P != 1 && P != 2) || nw < 1 || nw + 1 > MAXCOLS || ny < 3 || nx < 3)
    return (int)cudaErrorInvalidValue;
  const Cols c = make_cols(W, nw);
  const int b = bucket(nw);
  const bool l = last != 0;
#define LZ_PI(PP, BB) launch_pipe<PP, BB, OP>(l, scal, av, c, nw, op, wn, \
                                              avn, partial, ny, nx, ss, st)
  if (P == 1) {
    if (b == 4) LZ_PI(1, 4); else if (b == 8) LZ_PI(1, 8);
    else if (b == 16) LZ_PI(1, 16); else LZ_PI(1, 32);
  } else {
    if (b == 4) LZ_PI(2, 4); else if (b == 8) LZ_PI(2, 8);
    else if (b == 16) LZ_PI(2, 16); else LZ_PI(2, 32);
  }
#undef LZ_PI
  const int nout = 1 + 2 * nw + (l ? 0 : 2 * (nw + 1));
  reduce_partials<<<nout, RED_THREADS, 0, st>>>(partial, num_blocks(ny, nx),
                                                nout, red);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of blocks (= partial-sum rows) the K1/K2 launches use.
int lz_num_blocks(int ny, int nx) { return num_blocks(ny, nx); }

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
  return pass1_2d<OP_ISO>(P, scal, wj, prev, j, Op2d{nullptr, nullptr, clean},
                          Shard2d{}, w, partial, raw, ny, nx, ss, st);
}

// K1'. As K1, with the (ny, nx) zero-padded face weights wx, wy.
int lz_pass1_aniso2d(int P, const float* scal, const float* wj,
                     const float* const* prev, int j, const float* wx,
                     const float* wy, float* w, float* partial, float* raw,
                     int ny, int nx, float ss, cudaStream_t st) {
  if (wx == nullptr || wy == nullptr) return (int)cudaErrorInvalidValue;
  return pass1_2d<OP_ANISO>(P, scal, wj, prev, j, Op2d{wx, wy, 0}, Shard2d{},
                            w, partial, raw, ny, nx, ss, st);
}

// K1' in modes shard2d (aniso = 0: the Laplacian, clean selects the
// diagonal) and shard2d_aniso (aniso = 1: face weights wx, wy (ny, nx),
// wxl (ny), wyh (nx)) on one shard's (ny, nx) block at global offsets
// (y0, x0) of an (NY, NX) grid. yh: (P, 2, nx) halo rows, xh: (P, 2, ny)
// halo columns. Otherwise as K1.
int lz_pass1_shard2d(int P, int aniso, int clean, const float* scal,
                     const float* wj, const float* const* prev, int j,
                     const float* wx, const float* wy, const float* wxl,
                     const float* wyh, const float* yh, const float* xh,
                     float* w, float* partial, float* raw, int ny, int nx,
                     int y0, int x0, int NY, int NX, float ss,
                     cudaStream_t st) {
  if (yh == nullptr || xh == nullptr || y0 < 0 || x0 < 0 || y0 + ny > NY
      || x0 + nx > NX)
    return (int)cudaErrorInvalidValue;
  const Shard2d sh = {yh, xh, wxl, wyh, y0, x0, NY, NX};
  if (!aniso)
    return pass1_2d<OP_SHARD_ISO>(P, scal, wj, prev, j,
                                  Op2d{nullptr, nullptr, clean}, sh, w,
                                  partial, raw, ny, nx, ss, st);
  if (wx == nullptr || wy == nullptr || wxl == nullptr || wyh == nullptr)
    return (int)cudaErrorInvalidValue;
  return pass1_2d<OP_SHARD_ANISO>(P, scal, wj, prev, j, Op2d{wx, wy, 0}, sh,
                                  w, partial, raw, ny, nx, ss, st);
}

// K2. W: host array of nw = j+1 device pointers W_0..W_j. scal: (nw+1, 2)
// device buffer [(s_j, 0), c_0..c_j]. partial: scratch of lz_num_blocks *
// nout floats; red: nout outputs, nout = 1 + 2nw (+ 2(nw+1) unless last).
int lz_pipe_iso2d(int P, int last, const float* scal, const float* av,
                  const float* const* W, int nw, float* wn, float* avn,
                  float* partial, float* red, int ny, int nx, float ss,
                  int clean, cudaStream_t st) {
  return pipe_2d<OP_ISO>(P, last, scal, av, W, nw,
                         Op2d{nullptr, nullptr, clean}, wn, avn, partial, red,
                         ny, nx, ss, st);
}

// K2'. As K2, with the (ny, nx) zero-padded face weights wx, wy.
int lz_pipe_aniso2d(int P, int last, const float* scal, const float* av,
                    const float* const* W, int nw, const float* wx,
                    const float* wy, float* wn, float* avn, float* partial,
                    float* red, int ny, int nx, float ss, cudaStream_t st) {
  if (wx == nullptr || wy == nullptr) return (int)cudaErrorInvalidValue;
  return pipe_2d<OP_ANISO>(P, last, scal, av, W, nw, Op2d{wx, wy, 0}, wn,
                           avn, partial, red, ny, nx, ss, st);
}

// Rows of the partial-sum scratch of one K5 launch: lz_iter needs
// (2 MAXCOLS + 1) * lz_coop_max_blocks floats.
int lz_coop_max_blocks() { return coop_max_blocks(); }

// K5. opk: 0 iso2d, 1 aniso2d, 2 iso3d reference, 3 iso3d clean (nz = 1 in
// 2D; wx, wy are the aniso2d face weights, null otherwise). scal: (j+3)
// device buffer [s_j, bs, s_0..s_j]; prev: host array of j device pointers
// W_0..W_{j-1}; w: (P, nz*ny, nx) scratch; partial: scratch of
// (2 MAXCOLS + 1) * lz_coop_max_blocks floats; raw: (j+1, 2), nsq: (1, 1)
// outputs. A cooperative launch the card refuses returns its error.
int lz_iter(int P, int opk, const float* scal, const float* wj,
            const float* const* prev, int j, const float* wx, const float* wy,
            int clean, float* w, float* wn, float* partial, float* raw,
            float* nsq, int nz, int ny, int nx, float ss, cudaStream_t st) {
  if ((P != 1 && P != 2) || opk < OPK_ISO2D || opk > OPK_ISO3D_CLEAN
      || j < 0 || j + 1 > MAXCOLS || nz < 1 || ny < 3 || nx < 3
      || (opk >= OPK_ISO3D_REF && nz < 3))
    return (int)cudaErrorInvalidValue;
  if (opk == OPK_ANISO2D && (wx == nullptr || wy == nullptr))
    return (int)cudaErrorInvalidValue;
  const Cols c = make_cols(prev, j);
  const OpArgs a = {Op2d{wx, wy, clean}, nz, ny, nx, ss};
  float* part_b = partial + (size_t)2 * MAXCOLS * coop_max_blocks();
  const int b = bucket(j + 1);
  if (P == 1)
    return iter_op<1>(opk, b, scal, wj, c, j, a, w, wn, partial, part_b, raw,
                      nsq, st);
  return iter_op<2>(opk, b, scal, wj, c, j, a, w, wn, partial, part_b, raw,
                    nsq, st);
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
