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
//        the opt-in fused iteration (the phases are lz_iter.cuh's; K1 /
//        K1' run its phase 0 alone)
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
// subtraction) and writes W_{j+1}; w (8.4 MB at 1024^2) stays in shared
// memory between the phases where it fits on the card.
//
// What the design does about it:
// * Every column is read from device memory once per launch. K1 / K1' and
//   K5's first phase walk rows of 128-column strips on lz_tile.cuh's ring
//   (lz_iter.cuh's wpass): 16-byte loads, halo rows in the ring, side
//   neighbours by shuffles, the dots over lane groups; a fixed grid of the
//   blocks that fit on the card, block b owning one run of S / G rows of
//   the S strip rows. The shard policies (pass1_2d_kernel) keep one TY x TX
//   tile per block, the second and third touches of a value one row step
//   later from L1/L2.
// * K5 holds w in shared memory from its first phase to its second (the
//   block's own rows, behind a grid sync) where the field's w fits on the
//   card, and walks its rows backwards in the second phase, so that it
//   first reads the basis rows the first phase read last, from L2.
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
//   boundary, take the scalar instantiations (VEC = 1) of K1, K2, K3, K5.
// * The iso diagonal is computed from the row/column index, so it costs no
//   traffic.
// * Scalars (s_j, bs, c_i, q) are read from a device buffer, so no host sync
//   is needed between the scalar recurrence and the kernels.
// * Cross-block reductions are two-stage and deterministic, with no
//   atomics (reduce_partials, reduce_partials_om, lz_common.cuh).
// * K1 / K1' also sum ||W_j||^2 from the rows they read (the Lanczos run's
//   beta_0^2 at j = 0), one partial row more, so the run needs no separate
//   norm reduction.
// * A batch of B fields (the datagen engine's lanes, JAX's vmap of the
//   Pallas kernels) is one launch of K1 / K1', K2 / K2', K3, K5 or the shard
//   pass1: the lane is blockIdx.y (blockIdx.z for the shard pass1, whose
//   tiles take x and y; K5, a cooperative launch on one lane's grid, loops
//   over the lanes in each phase instead), fields are (B, P, ny, nx)
//   lane-major
//   (Cols carries lane 0's pointers and the lane stride), the scalars and
//   the aniso weights (and a shard's halos) come per lane, and each lane
//   keeps the unbatched
//   grid's block-to-segment or block-to-tile map and its own rows of
//   partial sums, reduced in the unbatched order. So lane b of a batched
//   launch gives the bits of the unbatched launch on lane b; an unbatched
//   call is the launch with B = 1.
//
// Plain C interface for ctypes: every launcher returns cudaGetLastError().

#include "lz_common.cuh"
#include "lz_iter.cuh"
#include "lz_stencil.cuh"
#include "lz_tile.cuh"

namespace {

constexpr int KMAX = 4;        // most specs one combine launch takes
struct Outs { float* p[KMAX]; };

// The operator of lane b of a batched launch (blockIdx.y, or K5's lane
// loop): its (ny, nx) face weights follow lane 0's, lane-major (the iso
// operator has none).
__device__ __forceinline__ Op2d lane_op(Op2d op, unsigned b, int ny,
                                        int nx) {
  if (op.wx != nullptr) {
    op.wx += b * (size_t)ny * nx;
    op.wy += b * (size_t)ny * nx;
  }
  return op;
}

// ---------------------------------------------------------------- K1 pass1
// K1 / K1' (OPK_ISO2D / OPK_ANISO2D): phase 0 of lz_iter.cuh (wpass) over a
// fixed grid of the blocks that fit on the card, block b owning the
// segments [b S / G, (b + 1) S / G) of the S rows of 128-column strips; w
// to w_out (through the per-warp rows wrow for the dots), the raw sums and
// ||W_j||^2 output-major to partial. MAXW bounds j; registers as
// PASS1_PER_SM. A batched launch runs lane blockIdx.y with the same block
// to segment map: its fields prev.ls floats apart, its scalars, face
// weights and 2j + 3 partial rows lane-major.
template <int P, int MAXW, int OPK, int VEC>
__global__ void __launch_bounds__(
    PT, (PASS1_PER_SM<P, MAXW, VEC>)) pass1_tile_kernel(
    const float* __restrict__ scal, const float* __restrict__ wj, Cols prev,
    int j, OpArgs a, float* __restrict__ w_out,
    float* __restrict__ partial) {
  constexpr int L = 32 / (MAXW / 4);  // lanes per dot group
  __shared__ __align__(16) float ring[RING][P][PX];
  __shared__ float hal[RING][P][2];
  __shared__ __align__(16) float wrow[PWARP][P][PX];
  __shared__ float red[PWARP][RED_W];
  __shared__ const float* wp[MAXCOLS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t off = blockIdx.y * prev.ls;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < MAXW; ++i)
      if (i < j) wp[i] = prev.p[i] + off;
  }
  __syncthreads();
  int s0, s1;
  block_segs(num_segs(a.ny, a.nx), s0, s1);
  const Op2d op = lane_op(a.op2, blockIdx.y, a.ny, a.nx);
  const float* sc = scal + 2 * blockIdx.y;
  const WLane ln = {wj + off, nullptr, w_out + off,
                    partial + (size_t)blockIdx.y * (2 * j + 3) * gridDim.x,
                    op.wx, op.wy, sc[0], sc[1]};
  wpass<P, MAXW, OPK, VEC, true>(ln, wp, j, a, s0, s1, &wrow[0][0][0], ring,
                                 hal, red, lane, w, lane / L, lane % L);
}

// K1' in modes shard2d and shard2d_aniso (OP_SHARD_ISO / OP_SHARD_ANISO):
// K1 on one shard's block, one TY x TX tile per block. MAXW bounds j (the
// number of earlier columns) so the per-column accumulators stay in
// registers. The shard policies take their halos, offsets and edge face
// weights from sh.
// A batched launch (LANES) runs lane blockIdx.z with the unbatched tile
// map: its fields prev.ls floats apart, its scalars, face weights, halos
// and partial rows lane-major (the offsets are every lane's). A launch of
// one lane takes LANES = false, the code without the lane offsets.
template <int P, int MAXW, int OP, bool LANES>
__global__ void __launch_bounds__(TX) pass1_2d_kernel(
    const float* __restrict__ scal, const float* __restrict__ wj, Cols prev,
    const float* __restrict__ wjm1, int j, Op2d op, Shard2d sh,
    float* __restrict__ w_out, float* __restrict__ partial, int ny, int nx,
    float ss) {
  static_assert(OP == OP_SHARD_ISO || OP == OP_SHARD_ANISO,
                "K1 and K1' run pass1_tile_kernel");
  __shared__ float red[NWARP][RED_W];
  const int t = threadIdx.x;
  const int x = blockIdx.x * TX + t;
  const int y0 = blockIdx.y * TY;
  const int rows = min(TY, ny - y0);
  const size_t plane = (size_t)ny * nx;
  const size_t off = LANES ? blockIdx.z * prev.ls : 0;
  if (LANES) {
    const unsigned b = blockIdx.z;
    wj += off;
    w_out += off;
    if (j > 0) wjm1 += off;
    op = lane_op(op, b, ny, nx);
    sh.yh += (size_t)b * 2 * P * nx;
    sh.xh += (size_t)b * 2 * P * ny;
    if (OP == OP_SHARD_ANISO) {
      sh.wxl += (size_t)b * ny;
      sh.wyh += (size_t)b * nx;
    }
    partial += (size_t)b * gridDim.y * gridDim.x * 2 * (j + 1);
    scal += 2 * b;
  }
  const float s = scal[0], bs = scal[1];

  float acc[MAXW][2] = {};
  float accj[2] = {0.0f, 0.0f};
  if (x < nx) {
    for (int rr = 0; rr < rows; ++rr) {
      const int r = y0 + rr;
      const size_t idx = (size_t)r * nx + x;
      float k[4];
      load_coef_shard<OP>(op, sh, r, x, nx, idx, k);
      float c[P], w[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* __restrict__ b = wj + p * plane;
        const float cv = __ldg(b + idx);
        float up, dn, lf, rt;
        neighbours_shard2d(b, sh, p, idx, r, x, ny, nx, up, dn, lf, rt);
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
          load<P>(prev.p[i], off + idx, plane, wi);
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
// A batched launch runs lane blockIdx.y with the same tile walk: its fields
// W.ls floats apart, its scalars, face weights and partial rows lane-major.
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
  const size_t off = blockIdx.y * W.ls;
  const int nout = 1 + 2 * nw + (LAST ? 0 : 2 * (nw + 1));
  scal += (size_t)blockIdx.y * 2 * (nw + 1);
  const float s = scal[0];
  for (int o = threadIdx.x; o < 2 * nw; o += PT) cf[o] = scal[2 + o];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < MAXW; ++i)
      if (i < nw) wp[i] = W.p[i] + off;
  }
  __syncthreads();
  const RebuildRows<P, VEC, LdNC> src = {av + off, wp, cf, nw, s, plane};
  pipe2d_pass<P, MAXW, LAST, OP, VEC, LdNC>(
      src, wp, nw, lane_op(op, blockIdx.y, ny, nx), wn_out + off,
      LAST ? av_out : av_out + off,
      partial + (size_t)blockIdx.y * nout * gridDim.x, ny, nx, ss, steps,
      ring, hal, avb, red, lane, w, q, gl);
}

// ---------------------------------------------------------------- K3 combine
// A fixed grid of the blocks that fit on the card walks the points in
// grid-stride order; each block loads the k m coefficients and the column
// pointers into shared memory once. A thread takes four points per visit,
// as one 16-byte vector per column and plane (VEC = 4: n % 4 == 0 and
// every pointer 16-byte aligned) or as one point (VEC = 1), and keeps up to
// four columns' loads in flight. A batched launch runs lane blockIdx.y with
// the same walk: its columns and outputs W.ls floats apart, its q 2 k m.
constexpr int CB = 256;               // threads per K3 block

template <int P, int VEC>
__global__ void __launch_bounds__(CB) combine_kernel(
    const float* __restrict__ q, Cols W, int m, int k, Outs out, size_t n) {
  __shared__ float qs[2 * KMAX * MAXCOLS];
  __shared__ const float* wp[MAXCOLS];
  const size_t off = blockIdx.y * W.ls;
  q += (size_t)blockIdx.y * 2 * k * m;
  for (int o = threadIdx.x; o < 2 * k * m; o += CB) qs[o] = q[o];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < MAXCOLS; ++i)
      if (i < m) wp[i] = W.p[i] + off;
  }
#pragma unroll
  for (int sp = 0; sp < KMAX; ++sp)
    if (sp < k) out.p[sp] += off;
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
// One whole iteration j in one cooperative launch: phase 0 (wpass), a grid
// sync, every block sums the raw dots (reduce_all) and forms q_i = s_i^2
// raw_i itself,
// phase 1 (subpass) over the same segments in reverse order, a grid sync,
// and block 0 writes ||W_{j+1}||^2 (block 0 also writes raw). scal: (j+3)
// [s_j, bs, s_0..s_j]. onchip: w in the dynamic shared memory (the block's
// rows); else w in the (P, rows, nx) global scratch w, and the dynamic
// shared memory holds the warps' w rows for the dots. part_a / part_b:
// partial-sum rows of the two phases, output-major. Two blocks per SM (128
// registers) but where ITER_PER_SM says one; MAXW bounds j.
//
// A batch of B lanes (fields (B, P, rows, nx) lane-major, prev.ls floats
// apart; scal (B, j+3), face weights, raw and nsq lane-major) is one
// launch on one lane's grid: every block walks its segments of lane 0, 1,
// ..., B-1 in each phase, between the same two grid syncs, its w rows of
// lane b at row b ceil(S / G) of the on-chip rows (or in lane b of the
// scratch), and writes lane b's partial sums to rows of their own
// (part_a + b 2 MAXCOLS G, part_b + b G). So each lane keeps the block to
// segment map and the reduction order of its launch alone: its bits. A
// cooperative grid is every block that fits on the card, so a lane cannot
// take a grid index of its own.
template <int P, int MAXW, int OPK, int VEC>
__global__ void __launch_bounds__(
    PT, (ITER_PER_SM<P, MAXW, VEC>)) iter_kernel(
    int nlanes, const float* __restrict__ scal,
    const float* __restrict__ wj, Cols prev, int j, OpArgs a, int onchip,
    float* w, float* __restrict__ wn_out, float* part_a, float* part_b,
    float* __restrict__ raw_out, float* __restrict__ nsq_out) {
  constexpr int L = 32 / (MAXW / 4);  // lanes per dot group
  constexpr int NWP = MAXW < MAXCOLS ? MAXW + 1 : MAXCOLS;
  __shared__ __align__(16) float ring[RING][P][PX];
  __shared__ float hal[RING][P][2];
  __shared__ float red[PWARP][RED_W];
  __shared__ float rs[2 * MAXCOLS], qs[2 * MAXCOLS];
  __shared__ const float* wp[MAXCOLS];
  __shared__ WLane ln;               // wpass's inputs of the lane
  extern __shared__ __align__(16) float dyn[];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nseg = num_segs(a.nz * a.ny, a.nx);
  const size_t G = gridDim.x;
  const size_t lrows = (nseg + G - 1) / G;   // on-chip w rows of a lane
  const int nraw = 2 * (j + 1);
  int s0, s1;
  block_segs(nseg, s0, s1);
  // wp: lane b's W_0..W_j, written by thread 0 where no thread reads it
  auto lane_cols = [&](int b) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < NWP; ++i)
        if (i <= j) wp[i] = (i < j ? prev.p[i] : wj) + b * prev.ls;
    }
  };
#pragma unroll 1
  for (int b = 0; b < nlanes; ++b) {
    __syncthreads();                  // the last lane's wp and ln are read
    lane_cols(b);
    if (threadIdx.x == 0) {
      const Op2d op = lane_op(a.op2, b, a.ny, a.nx);
      const float* sc = scal + (size_t)b * (j + 3);
      ln = {wj + b * prev.ls, onchip ? dyn + b * lrows * P * PX : nullptr,
            onchip ? nullptr : w + b * prev.ls,
            part_a + b * 2 * MAXCOLS * G, op.wx, op.wy, sc[0], sc[1]};
    }
    __syncthreads();
    wpass<P, MAXW, OPK, VEC>(ln, wp, j, a, s0, s1, dyn, ring, hal, red,
                             lane, wid, lane / L, lane % L);
  }
  grid.sync();
#pragma unroll 1
  for (int b = 0; b < nlanes; ++b) {
    lane_cols(b);                     // published by reduce_all's barrier
    const float* sc = scal + (size_t)b * (j + 3);
    reduce_all<PWARP>(part_a + b * 2 * MAXCOLS * G, nraw, rs);
    for (int o = threadIdx.x; o < nraw; o += PT) {
      const float si = sc[2 + o / 2];
      qs[o] = si * si * rs[o];
      if (blockIdx.x == 0) raw_out[(size_t)b * nraw + o] = rs[o];
    }
    __syncthreads();
    const size_t off = b * prev.ls;
    subpass<P, VEC>(wp, j + 1, qs, a, s0, s1,
                    onchip ? dyn + b * lrows * P * PX : nullptr,
                    onchip ? nullptr : w + off, wn_out + off, red,
                    part_b + b * G, lane, wid);
  }
  grid.sync();
  if (blockIdx.x == 0) {
    // lane b's sum is output b of the (nlanes, G) rows: reduce_all's order
    for (int b0 = 0; b0 < nlanes; b0 += 2 * MAXCOLS) {
      const int n = min(2 * MAXCOLS, nlanes - b0);
      reduce_all<PWARP>(part_b + b0 * G, n, rs);
      for (int o = threadIdx.x; o < n; o += PT) nsq_out[b0 + o] = rs[o];
      __syncthreads();
    }
  }
}

// Once per instantiation: let it take the dynamic shared memory of the
// on-chip form. The CUDA error, or 0.
template <int P, int MAXW, int OPK, int VEC>
int iter_ready() {
  static const int err = allow_dyn_smem(iter_kernel<P, MAXW, OPK, VEC>);
  return err;
}

// Blocks per SM of one iter_kernel instantiation with `dyn` bytes of
// dynamic shared memory (0 if none fits or the card refuses the query).
struct IterFit {
  int dyn;
  template <int P, int MAXW, int OPK, int VEC>
  int run() const {
    int occ = 0;
    if (iter_ready<P, MAXW, OPK, VEC>() != 0
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &occ, iter_kernel<P, MAXW, OPK, VEC>, PT, dyn) != cudaSuccess)
      return 0;
    return occ;
  }
};

// One K5 launch of an iter_kernel instantiation.
struct IterLaunch {
  int nlanes;
  const float* scal;
  const float* wj;
  Cols prev;
  int j;
  OpArgs a;
  int onchip, grid;
  size_t dyn;
  float *w, *wn, *part_a, *part_b, *raw, *nsq;
  cudaStream_t st;
  template <int P, int MAXW, int OPK, int VEC>
  int run() const {
    const int err = iter_ready<P, MAXW, OPK, VEC>();
    if (err != 0) return err;
    IterLaunch c = *this;
    void* args[] = {&c.nlanes, &c.scal, &c.wj, &c.prev, &c.j, &c.a,
                    &c.onchip, &c.w, &c.wn, &c.part_a, &c.part_b, &c.raw,
                    &c.nsq};
    return coop_launch(iter_kernel<P, MAXW, OPK, VEC>, grid, args, st, PT,
                       dyn);
  }
};

// f.run<P, MAXW, OPK, VEC>() for the instantiation of a call: b the bucket
// of j, vec the 16-byte form.
template <class F>
int iter_dispatch(int P, int opk, int b, bool vec, const F& f) {
#define LZ_V(PP, BB, OO) (vec ? f.template run<PP, BB, OO, 4>()           \
                              : f.template run<PP, BB, OO, 1>())
#define LZ_B(PP, OO) (b == 4 ? LZ_V(PP, 4, OO) : b == 8 ? LZ_V(PP, 8, OO) \
                      : b == 16 ? LZ_V(PP, 16, OO) : LZ_V(PP, 32, OO))
#define LZ_O(PP) (opk == OPK_ISO2D ? LZ_B(PP, OPK_ISO2D)                  \
                  : opk == OPK_ANISO2D ? LZ_B(PP, OPK_ANISO2D)            \
                  : opk == OPK_ISO3D_REF ? LZ_B(PP, OPK_ISO3D_REF)        \
                  : LZ_B(PP, OPK_ISO3D_CLEAN))
  return P == 1 ? LZ_O(1) : LZ_O(2);
#undef LZ_O
#undef LZ_B
#undef LZ_V
}

// Bytes of dynamic shared memory of a K5 launch on B lanes: the block's w
// rows of every lane (on-chip), or the warps' w rows.
size_t iter_dyn_bytes(int B, int P, int onchip, int nseg, int grid) {
  const size_t rows =
      onchip ? (size_t)B * ((nseg + grid - 1) / grid) : PWARP;
  return rows * P * PX * sizeof(float);
}

// ---------------------------------------------------------------- launchers

// The shard pass1 over B lanes (blockIdx.z), each lane's tiles as one
// unbatched launch's; one lane without the lane offsets.
template <int P, int MAXW, int OP>
void launch_pass1(int B, const float* scal, const float* wj, Cols prev,
                  int j, const Op2d& op, const Shard2d& sh, float* w,
                  float* partial, int ny, int nx, float ss,
                  cudaStream_t st) {
  dim3 g = tile_grid(ny, nx);
  g.z = B;
  const float* wjm1 = j > 0 ? prev.p[j - 1] : nullptr;
  if (B > 1)
    pass1_2d_kernel<P, MAXW, OP, true><<<g, TX, 0, st>>>(
        scal, wj, prev, wjm1, j, op, sh, w, partial, ny, nx, ss);
  else
    pass1_2d_kernel<P, MAXW, OP, false><<<g, TX, 0, st>>>(
        scal, wj, prev, wjm1, j, op, sh, w, partial, ny, nx, ss);
}

// K1 / K1' on the walker over B lanes, then the reduction of its
// output-major partials, lane by lane.
template <int P, int MAXW, int OPK, int VEC>
int launch_pass1_tile(int B, const float* scal, const float* wj, Cols prev,
                      int j, const OpArgs& a, float* w, float* partial,
                      float* raw, cudaStream_t st) {
  auto kern = pass1_tile_kernel<P, MAXW, OPK, VEC>;
  static const int fit = resident_blocks(kern, PT);
  if (fit <= 0) return (int)cudaErrorInvalidConfiguration;
  const int nseg = num_segs(a.ny, a.nx);
  const int grid = nseg < fit ? nseg : fit;
  kern<<<dim3(grid, B), PT, 0, st>>>(scal, wj, prev, j, a, w, partial);
  reduce_partials_om<<<dim3(2 * j + 3, B), RED_THREADS, 0, st>>>(
      partial, grid, raw);
  return (int)cudaGetLastError();
}

// K1 (OPK_ISO2D) / K1' (OPK_ANISO2D) on B lanes. The 16-byte instantiation
// takes rows of nx % 4 == 0 columns and 16-byte aligned fields and weights
// (then every lane's are); any other call takes the scalar one.
template <int OPK>
int pass1_tile(int B, int P, const float* scal, const float* wj,
               const float* const* prev, int j, const Op2d& op, float* w,
               float* partial, float* raw, int ny, int nx, float ss,
               cudaStream_t st) {
  if (B < 1 || B > 65535 || (P != 1 && P != 2) || j < 0 || j + 1 > MAXCOLS
      || ny < 3 || nx < 3)
    return (int)cudaErrorInvalidValue;
  const Cols c = make_cols(prev, j, (size_t)P * ny * nx);
  const OpArgs a = {op, 1, ny, nx, ss};
  bool vec = nx % 4 == 0 && aligned16(wj) && aligned16(w);
  for (int i = 0; i < j; ++i) vec = vec && aligned16(prev[i]);
  if (OPK == OPK_ANISO2D) vec = vec && aligned16(op.wx) && aligned16(op.wy);
  const int b = bucket(j);
#define LZ_T(PP, BB) (vec ? launch_pass1_tile<PP, BB, OPK, 4>(              \
                                B, scal, wj, c, j, a, w, partial, raw, st)  \
                          : launch_pass1_tile<PP, BB, OPK, 1>(              \
                                B, scal, wj, c, j, a, w, partial, raw, st))
#define LZ_B(PP) (b == 4 ? LZ_T(PP, 4) : b == 8 ? LZ_T(PP, 8)                \
                  : b == 16 ? LZ_T(PP, 16) : LZ_T(PP, 32))
  return P == 1 ? LZ_B(1) : LZ_B(2);
#undef LZ_B
#undef LZ_T
}

// K2 / K2' over B lanes, each lane's tiles as one unbatched launch's.
template <int P, int MAXW, bool LAST, int OP, int VEC>
int launch_pipe(int B, const float* scal, const float* av, Cols W, int nw,
                const Op2d& op, float* wn, float* avn, float* partial,
                float* red, int ny, int nx, float ss, cudaStream_t st) {
  auto kern = pipe_2d_kernel<P, MAXW, LAST, OP, VEC>;
  static const int fit = resident_blocks(kern, PT);
  if (fit <= 0) return (int)cudaErrorInvalidConfiguration;
  const int steps = pipe_steps(ny, nx, fit);
  const int tiles = pipe_tiles(ny, nx, steps);
  const int grid = tiles < fit ? tiles : fit;
  kern<<<dim3(grid, B), PT, 0, st>>>(scal, av, W, nw, op, wn, avn, partial,
                                     ny, nx, ss, steps);
  const int nout = 1 + 2 * nw + (LAST ? 0 : 2 * (nw + 1));
  reduce_partials_om<<<dim3(nout, B), RED_THREADS, 0, st>>>(partial, grid,
                                                            red);
  return (int)cudaGetLastError();
}

template <int P, int MAXW, int OP>
int pipe_vec(int B, bool last, bool vec, const float* scal, const float* av,
             Cols W, int nw, const Op2d& op, float* wn, float* avn,
             float* partial, float* red, int ny, int nx, float ss,
             cudaStream_t st) {
#define LZ_PV(LL, OO, VV) launch_pipe<P, MAXW, LL, OO, VV>(                \
    B, scal, av, W, nw, op, wn, avn, partial, red, ny, nx, ss, st)
  if (last) return vec ? LZ_PV(true, OP_ISO, 4) : LZ_PV(true, OP_ISO, 1);
  return vec ? LZ_PV(false, OP, 4) : LZ_PV(false, OP, 1);
#undef LZ_PV
}

int num_blocks(int ny, int nx) {
  const dim3 g = tile_grid(ny, nx);
  return (int)(g.x * g.y);
}

// K1' shard2d / shard2d_aniso with the shard policy OP on B lanes, then
// the reduction of its partial sums, lane by lane. A shard's block may have
// sides of 2 (its halos hold the neighbours).
template <int OP>
int pass1_2d(int B, int P, const float* scal, const float* wj,
             const float* const* prev, int j, const Op2d& op,
             const Shard2d& sh, float* w, float* partial, float* raw, int ny,
             int nx, float ss, cudaStream_t st) {
  if (B < 1 || B > 65535 || (P != 1 && P != 2) || j < 0 || j + 1 > MAXCOLS
      || ny < 2 || nx < 2)
    return (int)cudaErrorInvalidValue;
  const Cols c = make_cols(prev, j, (size_t)P * ny * nx);
  const int b = bucket(j);
#define LZ_P1(PP, BB) launch_pass1<PP, BB, OP>(B, scal, wj, c, j, op, sh, w, \
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
  reduce_partials<<<dim3(nout, B), RED_THREADS, 0, st>>>(
      partial, num_blocks(ny, nx), nout, raw);
  return (int)cudaGetLastError();
}

// K2 / K2' with the operator OP on B lanes, then the reduction of its
// partial sums. The 16-byte instantiation takes rows of nx % 4 == 0
// columns and 16-byte aligned fields; any other call takes the scalar one.
template <int OP>
int pipe_2d(int B, int P, int last, const float* scal, const float* av,
            const float* const* W, int nw, const Op2d& op, float* wn,
            float* avn, float* partial, float* red, int ny, int nx, float ss,
            cudaStream_t st) {
  if (B < 1 || B > 65535 || (P != 1 && P != 2) || nw < 1
      || nw + 1 > MAXCOLS || ny < 3 || nx < 3)
    return (int)cudaErrorInvalidValue;
  const Cols c = make_cols(W, nw, (size_t)P * ny * nx);
  const int b = bucket(nw);
  const bool l = last != 0;
  bool vec = nx % 4 == 0 && aligned16(av) && aligned16(wn)
             && (l || aligned16(avn));
  for (int i = 0; i < nw; ++i) vec = vec && aligned16(W[i]);
  if (OP == OP_ANISO && !l) vec = vec && aligned16(op.wx) && aligned16(op.wy);
#define LZ_PI(PP, BB) pipe_vec<PP, BB, OP>(B, l, vec, scal, av, c, nw, op,  \
                                           wn, avn, partial, red, ny, nx,   \
                                           ss, st)
  if (P == 1)
    return b == 4 ? LZ_PI(1, 4) : b == 8 ? LZ_PI(1, 8)
           : b == 16 ? LZ_PI(1, 16) : LZ_PI(1, 32);
  return b == 4 ? LZ_PI(2, 4) : b == 8 ? LZ_PI(2, 8)
         : b == 16 ? LZ_PI(2, 16) : LZ_PI(2, 32);
#undef LZ_PI
}

template <int P, int VEC>
int launch_combine(int B, const float* q, Cols W, int m, int k, Outs o,
                   size_t n, cudaStream_t st) {
  auto kern = combine_kernel<P, VEC>;
  static const int fit = resident_blocks(kern, CB);
  const size_t need = (n / VEC + CB - 1) / CB;
  const int grid = need < (size_t)fit ? (int)need : fit;
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  kern<<<dim3(grid, B), CB, 0, st>>>(q, W, m, k, o, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of blocks (= partial-sum rows) of one lane of a pass1_shard2d
// launch.
int lz_num_blocks(int ny, int nx) { return num_blocks(ny, nx); }

// Most blocks (= partial sums per output) a K1 / K1' launch uses.
int lz_pass1_blocks() { return pipe_max_blocks(); }

// Most blocks (= partial sums per output) a K2 launch uses.
int lz_pipe_blocks() { return pipe_max_blocks(); }

int lz_max_cols() { return MAXCOLS; }
const char* lz_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
int lz_max_specs() { return KMAX; }

// K1 on B lanes (B = 1: one field). Every field is (B, P, ny, nx),
// lane-major; prev: host array of j device pointers W_0..W_{j-1} (lane 0's
// rows); scal: (B, 2) [s_j, bs] per lane. partial: scratch of
// lz_pass1_blocks * B (2j + 3) floats. raw: (B, 2j + 3) output, per lane
// raw_i (re, im), i <= j, then ||W_j||^2.
int lz_pass1_iso2d(int B, int P, const float* scal, const float* wj,
                   const float* const* prev, int j, float* w, float* partial,
                   float* raw, int ny, int nx, float ss, int clean,
                   cudaStream_t st) {
  return pass1_tile<OPK_ISO2D>(B, P, scal, wj, prev, j,
                               Op2d{nullptr, nullptr, clean}, w, partial, raw,
                               ny, nx, ss, st);
}

// K1'. As K1, with the zero-padded face weights wx, wy: (B, ny, nx), each
// lane its own.
int lz_pass1_aniso2d(int B, int P, const float* scal, const float* wj,
                     const float* const* prev, int j, const float* wx,
                     const float* wy, float* w, float* partial, float* raw,
                     int ny, int nx, float ss, cudaStream_t st) {
  if (wx == nullptr || wy == nullptr) return (int)cudaErrorInvalidValue;
  return pass1_tile<OPK_ANISO2D>(B, P, scal, wj, prev, j, Op2d{wx, wy, 0}, w,
                                 partial, raw, ny, nx, ss, st);
}

// K1' in modes shard2d (aniso = 0: the Laplacian, clean selects the
// diagonal) and shard2d_aniso (aniso = 1: face weights wx, wy (B, ny, nx),
// wxl (B, ny), wyh (B, nx)) on one shard's (ny, nx) block at global offsets
// (y0, x0) of an (NY, NX) grid, for B lanes (B = 1: one field; every lane
// at the same offsets). yh: (B, P, 2, nx) halo rows, xh: (B, P, 2, ny) halo
// columns. partial: scratch of lz_num_blocks * B * 2(j+1) floats; raw: (B,
// j+1, 2). Otherwise as K1.
int lz_pass1_shard2d(int B, int P, int aniso, int clean, const float* scal,
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
    return pass1_2d<OP_SHARD_ISO>(B, P, scal, wj, prev, j,
                                  Op2d{nullptr, nullptr, clean}, sh, w,
                                  partial, raw, ny, nx, ss, st);
  if (wx == nullptr || wy == nullptr || wxl == nullptr || wyh == nullptr)
    return (int)cudaErrorInvalidValue;
  return pass1_2d<OP_SHARD_ANISO>(B, P, scal, wj, prev, j, Op2d{wx, wy, 0},
                                  sh, w, partial, raw, ny, nx, ss, st);
}

// K2 on B lanes (B = 1: one field). Every field is (B, P, ny, nx),
// lane-major; W: host array of nw = j+1 device pointers W_0..W_j (lane 0's).
// scal: (B, nw+1, 2) device buffer [(s_j, 0), c_0..c_j] per lane. partial:
// scratch of lz_pipe_blocks * B nout floats; red: (B, nout) outputs, nout =
// 1 + 2nw (+ 2(nw+1) unless last).
int lz_pipe_iso2d(int B, int P, int last, const float* scal, const float* av,
                  const float* const* W, int nw, float* wn, float* avn,
                  float* partial, float* red, int ny, int nx, float ss,
                  int clean, cudaStream_t st) {
  return pipe_2d<OP_ISO>(B, P, last, scal, av, W, nw,
                         Op2d{nullptr, nullptr, clean}, wn, avn, partial, red,
                         ny, nx, ss, st);
}

// K2'. As K2, with the zero-padded face weights wx, wy: (B, ny, nx), each
// lane its own.
int lz_pipe_aniso2d(int B, int P, int last, const float* scal,
                    const float* av, const float* const* W, int nw,
                    const float* wx, const float* wy, float* wn, float* avn,
                    float* partial, float* red, int ny, int nx, float ss,
                    cudaStream_t st) {
  if (wx == nullptr || wy == nullptr) return (int)cudaErrorInvalidValue;
  return pipe_2d<OP_ANISO>(B, P, last, scal, av, W, nw, Op2d{wx, wy, 0}, wn,
                           avn, partial, red, ny, nx, ss, st);
}

// Rows of the partial-sum scratch of one K5 launch: lz_iter needs
// B (2 MAXCOLS + 1) * lz_coop_max_blocks floats for B lanes.
int lz_coop_max_blocks() { return coop_max_blocks(); }

int lz_num_sms() { return num_sms(); }

// Blocks per SM of the K5 instantiation of (P, opk, j, vec) that fit with
// dyn bytes of dynamic shared memory: lanczos2d.py's iter_plan.
int lz_iter_fit(int P, int opk, int j, int vec, int dyn) {
  if ((P != 1 && P != 2) || opk < OPK_ISO2D || opk > OPK_ISO3D_CLEAN
      || j < 0 || j + 1 > MAXCOLS || dyn < 0)
    return 0;
  return iter_dispatch(P, opk, bucket(j), vec != 0, IterFit{dyn});
}

// K5 on B lanes (B = 1: one field). opk: 0 iso2d, 1 aniso2d, 2 iso3d
// reference, 3 iso3d clean (nz = 1 in 2D; wx, wy are the aniso2d face
// weights, (B, ny, nx), null otherwise). scal: (B, j+3) device buffer
// [s_j, bs, s_0..s_j] per lane; prev: host array of j device pointers
// W_0..W_{j-1} (lane 0's); every field is (B, P, nz*ny, nx), lane-major.
// vec: the 16-byte form (nx % 4 == 0, every field and weight 16-byte
// aligned). onchip, grid: iter_plan's form and grid (at most
// lz_coop_max_blocks blocks, at most one per segment; on chip, B lanes' w
// rows per block); w: the (B, P, nz*ny, nx) scratch of the global form
// (unused on chip); partial: scratch of B (2 MAXCOLS + 1) *
// lz_coop_max_blocks floats; raw: (B, j+1, 2), nsq: (B, 1, 1) outputs. A
// cooperative launch the card refuses returns its error.
int lz_iter(int B, int P, int opk, int vec, const float* scal,
            const float* wj, const float* const* prev, int j,
            const float* wx, const float* wy, int clean, int onchip,
            int grid, float* w, float* wn, float* partial, float* raw,
            float* nsq, int nz, int ny, int nx, float ss, cudaStream_t st) {
  if (B < 1 || (P != 1 && P != 2) || opk < OPK_ISO2D
      || opk > OPK_ISO3D_CLEAN || j < 0 || j + 1 > MAXCOLS || nz < 1
      || ny < 3 || nx < 3 || (opk >= OPK_ISO3D_REF && nz < 3))
    return (int)cudaErrorInvalidValue;
  if (opk == OPK_ANISO2D && (wx == nullptr || wy == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nseg = num_segs(nz * ny, nx);
  if (grid < 1 || grid > coop_max_blocks() || grid > nseg
      || (!onchip && w == nullptr))
    return (int)cudaErrorInvalidValue;
  if (vec) {
    bool ok = nx % 4 == 0 && aligned16(wj) && aligned16(wn)
              && aligned16(wx) && aligned16(wy) && (onchip || aligned16(w));
    for (int i = 0; i < j; ++i) ok = ok && aligned16(prev[i]);
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  const IterLaunch f = {B, scal, wj,
                        make_cols(prev, j, (size_t)P * nz * ny * nx), j,
                        OpArgs{Op2d{wx, wy, clean}, nz, ny, nx, ss},
                        onchip != 0, grid,
                        iter_dyn_bytes(B, P, onchip, nseg, grid), w, wn,
                        partial,
                        partial + (size_t)B * 2 * MAXCOLS * coop_max_blocks(),
                        raw, nsq, st};
  return iter_dispatch(P, opk, bucket(j), vec != 0, f);
}

// K3 on B lanes (B = 1: one field). q: (B, k, m, 2) device buffer. W:
// host array of m device pointers (lane 0's), outs: host array of k device
// pointers to outputs (lane 0's); every field is (B, P, ny, nx), lane-major.
int lz_combine(int B, int P, const float* q, const float* const* W, int m,
               int k, float* const* outs, int ny, int nx, cudaStream_t st) {
  if (B < 1 || B > 65535 || (P != 1 && P != 2) || m < 1 || m > MAXCOLS
      || k < 1 || k > KMAX)
    return (int)cudaErrorInvalidValue;
  const Cols c = make_cols(W, m, (size_t)P * ny * nx);
  Outs o = {};
  const size_t n = (size_t)ny * nx;
  bool vec = n % 4 == 0;
  for (int i = 0; i < k; ++i) {
    o.p[i] = outs[i];
    vec = vec && aligned16(outs[i]);
  }
  for (int i = 0; i < m; ++i) vec = vec && aligned16(W[i]);
  if (P == 1)
    return vec ? launch_combine<1, 4>(B, q, c, m, k, o, n, st)
               : launch_combine<1, 1>(B, q, c, m, k, o, n, st);
  return vec ? launch_combine<2, 4>(B, q, c, m, k, o, n, st)
             : launch_combine<2, 1>(B, q, c, m, k, o, n, st);
}

}  // extern "C"
