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
// * Every column is read from device memory once per launch. K1 owns a
//   TY x TX tile and walks it row by row; the second and third touches of a
//   value (a dot after the reconstruction, a stencil neighbour) come one row
//   step later from L1/L2, not from DRAM.
// * K2 needs the stencil of the column it is building. A block of eight
//   warps rebuilds W_{j+1} on tiles of 128 columns by 8 S - 2 rows (S
//   steps of eight rows) plus their halo rows, into a shared ring; lanes 0
//   and 31 rebuild the two halo columns in the same pass, and the stencil
//   takes its left and right neighbours by warp shuffles across the 16-byte
//   groups. gram_i and d_i come from one load of W_i at the stencilled row,
//   with the dot columns split over lane groups, so no bucket spills. A
//   fixed grid of the blocks that fit on the card walks the tiles, and S is
//   picked so that the busiest block takes the fewest steps. The partial
//   sums are stored output-major and reduced by reduce_partials_om. The
//   walker is lz_tile.cuh's, shared with K8 and K13.
// * K3 loads the coefficients and column pointers into shared memory once
//   per block, reads 16-byte vectors (four points) per column and plane,
//   and walks the points in grid-stride order over a fixed grid.
// * Rows whose width is not a multiple of 4, or fields off a 16-byte
//   boundary, take K2's and K3's scalar instantiations (VEC = 1).
// * The iso diagonal is computed from the row/column index, so it costs no
//   traffic.
// * Scalars (s_j, bs, c_i, q) are read from a device buffer, so no host sync
//   is needed between the scalar recurrence and the kernels.
// * Cross-block reductions are two-stage and deterministic, with no
//   atomics (reduce_partials, reduce_partials_om, lz_common.cuh).
//
// Plain C interface for ctypes: every launcher returns cudaGetLastError().

#include "lz_common.cuh"
#include "lz_iter.cuh"
#include "lz_stencil.cuh"
#include "lz_tile.cuh"

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
// One pipe pass of lz_tile.cuh over a rebuilt column: tiles of PX columns
// by ty = PWARP * S - 2 rows (2 <= S <= 8 steps), walked by blocks of PT
// threads in a fixed order (block b takes tiles b, b + G, b + 2G, ... of a
// grid of G blocks that fit on the card at once, and sums into the same
// accumulators across its tiles).
// MAXW bounds nw = j + 1, the number of basis columns. LAST computes no
// stencil, so its one instantiation (OP_ISO) serves both operators.
// partial: output-major, partial[o * gridDim.x + block].
// Two blocks per SM (128 registers) for the 16-byte forms; the scalar
// forms and the real 32-column one need more registers than that.
template <int P, int MAXW, bool LAST, int OP, int VEC>
__global__ void __launch_bounds__(
    PT, VEC == 4 && (P == 2 || MAXW < 32) ? 2 : 1) pipe_2d_kernel(
    const float* __restrict__ scal, const float* __restrict__ av, Cols W,
    int nw, Op2d op, float* __restrict__ wn_out, float* __restrict__ av_out,
    float* __restrict__ partial, int ny, int nx, float ss, int steps) {
  constexpr int NG = MAXW / 4;        // dot groups per warp
  constexpr int L = 32 / NG;          // lanes per dot group
  __shared__ __align__(16) float ring[LAST ? PWARP : RING][P][PX];
  __shared__ float hal[LAST ? 1 : RING][P][2];
  __shared__ __align__(16) float avb[LAST ? 1 : PWARP][P][PX];
  __shared__ float red[PWARP][RED_W];
  __shared__ float cf[2 * MAXW];
  __shared__ const float* wp[MAXW];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int q = lane / L, gl = lane % L;
  const size_t plane = (size_t)ny * nx;
  const float s = scal[0];
  for (int o = threadIdx.x; o < 2 * nw; o += PT) cf[o] = scal[2 + o];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < MAXW; ++i)
      if (i < nw) wp[i] = W.p[i];
  }
  __syncthreads();
  const RebuildRows<P, VEC, LdNC> src = {av, wp, cf, nw, s, plane};
  pipe2d_pass<P, MAXW, LAST, OP, VEC, LdNC>(src, wp, nw, op, wn_out, av_out,
                                            partial, ny, nx, ss, steps, ring,
                                            hal, avb, red, lane, w, q, gl);
}

// ---------------------------------------------------------------- K3 combine
// A fixed grid of the blocks that fit on the card walks the points in
// grid-stride order; each block loads the k m coefficients and the column
// pointers into shared memory once. A thread takes four points per visit,
// as one 16-byte vector per column and plane (VEC = 4: n % 4 == 0 and
// every pointer 16-byte aligned) or as one point (VEC = 1), and keeps up to
// four columns' loads in flight.
constexpr int CB = 256;               // threads per K3 block

template <int P, int VEC>
__global__ void __launch_bounds__(CB) combine_kernel(
    const float* __restrict__ q, Cols W, int m, int k, Outs out, size_t n) {
  __shared__ float qs[2 * KMAX * MAXCOLS];
  __shared__ const float* wp[MAXCOLS];
  for (int o = threadIdx.x; o < 2 * k * m; o += CB) qs[o] = q[o];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < MAXCOLS; ++i)
      if (i < m) wp[i] = W.p[i];
  }
  __syncthreads();
  const size_t nvec = n / VEC;
  const size_t stride = (size_t)gridDim.x * CB;
  for (size_t e = (size_t)blockIdx.x * CB + threadIdx.x; e < nvec;
       e += stride) {
    float y[KMAX][P][VEC];
    auto load = [&](int i, float (&w)[P][VEC]) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (VEC == 4) {
          const float4 t = __ldg(
              reinterpret_cast<const float4*>(wp[i] + p * n) + e);
          w[p][0] = t.x; w[p][1] = t.y; w[p][2] = t.z; w[p][3] = t.w;
        } else {
          w[p][0] = __ldg(wp[i] + p * n + e);
        }
      }
    };
    {
      float w[P][VEC];
      load(0, w);
#pragma unroll
      for (int sp = 0; sp < KMAX; ++sp) {
        if (sp < k) {
          const float a = qs[2 * sp * m], b = qs[2 * sp * m + 1];
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            if (P == 1) {
              y[sp][0][c] = a * w[0][c];
            } else {
              y[sp][0][c] = a * w[0][c] - b * w[P - 1][c];
              y[sp][P - 1][c] = a * w[P - 1][c] + b * w[0][c];
            }
          }
        }
      }
    }
#pragma unroll 4
    for (int i = 1; i < m; ++i) {
      float w[P][VEC];
      load(i, w);
#pragma unroll
      for (int sp = 0; sp < KMAX; ++sp) {
        if (sp < k) {
          const float a = qs[2 * (sp * m + i)], b = qs[2 * (sp * m + i) + 1];
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            if (P == 1) {
              y[sp][0][c] = y[sp][0][c] + a * w[0][c];
            } else {
              y[sp][0][c] = y[sp][0][c] + a * w[0][c] - b * w[P - 1][c];
              y[sp][P - 1][c] = y[sp][P - 1][c] + a * w[P - 1][c]
                                + b * w[0][c];
            }
          }
        }
      }
    }
#pragma unroll
    for (int sp = 0; sp < KMAX; ++sp) {
      if (sp < k) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (VEC == 4)
            reinterpret_cast<float4*>(out.p[sp] + p * n)[e] = make_float4(
                y[sp][p][0], y[sp][p][1], y[sp][p][2], y[sp][p][3]);
          else
            out.p[sp][p * n + e] = y[sp][p][0];
        }
      }
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

template <int P, int MAXW, bool LAST, int OP, int VEC>
int launch_pipe(const float* scal, const float* av, Cols W, int nw,
                const Op2d& op, float* wn, float* avn, float* partial,
                float* red, int ny, int nx, float ss, cudaStream_t st) {
  auto kern = pipe_2d_kernel<P, MAXW, LAST, OP, VEC>;
  static const int fit = resident_blocks(kern, PT);
  if (fit <= 0) return (int)cudaErrorInvalidConfiguration;
  const int steps = pipe_steps(ny, nx, fit);
  const int tiles = pipe_tiles(ny, nx, steps);
  const int grid = tiles < fit ? tiles : fit;
  kern<<<grid, PT, 0, st>>>(scal, av, W, nw, op, wn, avn, partial, ny, nx,
                            ss, steps);
  const int nout = 1 + 2 * nw + (LAST ? 0 : 2 * (nw + 1));
  reduce_partials_om<<<nout, RED_THREADS, 0, st>>>(partial, grid, red);
  return (int)cudaGetLastError();
}

template <int P, int MAXW, int OP>
int pipe_vec(bool last, bool vec, const float* scal, const float* av,
             Cols W, int nw, const Op2d& op, float* wn, float* avn,
             float* partial, float* red, int ny, int nx, float ss,
             cudaStream_t st) {
#define LZ_PV(LL, OO, VV) launch_pipe<P, MAXW, LL, OO, VV>(                \
    scal, av, W, nw, op, wn, avn, partial, red, ny, nx, ss, st)
  if (last) return vec ? LZ_PV(true, OP_ISO, 4) : LZ_PV(true, OP_ISO, 1);
  return vec ? LZ_PV(false, OP, 4) : LZ_PV(false, OP, 1);
#undef LZ_PV
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
// The 16-byte instantiation takes rows of nx % 4 == 0 columns and 16-byte
// aligned fields; any other call takes the scalar one.
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
  bool vec = nx % 4 == 0 && aligned16(av) && aligned16(wn)
             && (l || aligned16(avn));
  for (int i = 0; i < nw; ++i) vec = vec && aligned16(W[i]);
  if (OP == OP_ANISO && !l) vec = vec && aligned16(op.wx) && aligned16(op.wy);
#define LZ_PI(PP, BB) pipe_vec<PP, BB, OP>(l, vec, scal, av, c, nw, op, wn, \
                                           avn, partial, red, ny, nx, ss, st)
  if (P == 1)
    return b == 4 ? LZ_PI(1, 4) : b == 8 ? LZ_PI(1, 8)
           : b == 16 ? LZ_PI(1, 16) : LZ_PI(1, 32);
  return b == 4 ? LZ_PI(2, 4) : b == 8 ? LZ_PI(2, 8)
         : b == 16 ? LZ_PI(2, 16) : LZ_PI(2, 32);
#undef LZ_PI
}

template <int P, int VEC>
int launch_combine(const float* q, Cols W, int m, int k, Outs o, size_t n,
                   cudaStream_t st) {
  auto kern = combine_kernel<P, VEC>;
  static const int fit = resident_blocks(kern, CB);
  const size_t need = (n / VEC + CB - 1) / CB;
  const int grid = need < (size_t)fit ? (int)need : fit;
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  kern<<<grid, CB, 0, st>>>(q, W, m, k, o, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of blocks (= partial-sum rows) the K1 launches use.
int lz_num_blocks(int ny, int nx) { return num_blocks(ny, nx); }

// Most blocks (= partial sums per output) a K2 launch uses.
int lz_pipe_blocks() { return pipe_max_blocks(); }

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
// device buffer [(s_j, 0), c_0..c_j]. partial: scratch of lz_pipe_blocks *
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
  const size_t n = (size_t)ny * nx;
  bool vec = n % 4 == 0;
  for (int i = 0; i < k; ++i) {
    o.p[i] = outs[i];
    vec = vec && aligned16(outs[i]);
  }
  for (int i = 0; i < m; ++i) vec = vec && aligned16(W[i]);
  if (P == 1)
    return vec ? launch_combine<1, 4>(q, c, m, k, o, n, st)
               : launch_combine<1, 1>(q, c, m, k, o, n, st);
  return vec ? launch_combine<2, 4>(q, c, m, k, o, n, st)
             : launch_combine<2, 1>(q, c, m, k, o, n, st);
}

}  // extern "C"
