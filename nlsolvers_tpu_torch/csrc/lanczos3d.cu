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
//               on one shard's block of a sharded grid, in the shard modes
//               SHARD_REF, SHARD_CLEAN, SHARD_ANISO, a kernel of its own
//
// The TPU split pass1 into y-slab and z-by-y brick kernels (and their
// sharded twins) only to fit its blocks into VMEM; the function is the
// same, so here it is one kernel with the operator as a mode (and one for
// the shard modes). On a shard the neighbours outside the block come from
// halo arrays, copied into the frame of the kernel's plane ring, and the
// iso diagonal from the block's global offsets, so a shard costs what an
// unsharded block of its size costs, plus its halos.
//
// Fields are planar float32 (P, R, nx) on the merged row view R = nz * ny;
// the operator modes (ISO_REF with the reference's y-seam, ISO_CLEAN,
// ANISO) and their stencil are lz_stencil.cuh's.
//
// What bounds them on an H100: bytes streamed from device memory; the
// arithmetic is a few flops per loaded float. pass1 at iteration j reads
// j + 1 columns and writes 1 (plus three weight planes for ANISO), pass2
// reads j + 2 and writes 1, pipe_3d reads j + 2 and writes 2 (plus the
// three weight planes). At 128^3 complex64 a column is 16.8 MB.
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
// * pipe_3d is one pipe pass of lz_tile.cuh (K2's walker) on bricks of
//   128 columns x 6 rows x pz planes: each row is rebuilt once into a
//   4-plane ring in shared memory with 16-byte loads (lanes 0 and 31 take
//   the halo columns; at nx = 128 there are none), stencilled from the
//   ring, and its gram and d dots taken from one load of each W_i over
//   lane groups, so no bucket spills. The wrapper picks pz per grid so that
//   the busiest block takes the fewest plane steps. What is left above the
//   bytes bound: the halo (a brick rebuilds 8 rows of pz + 2 planes to
//   stencil 6 x pz) and the dots' second read of each W_i, which comes from
//   L2 (see the kernel). Neighbouring bricks march z in opposite
//   directions, so that a shared halo plane is rebuilt by both at about the
//   same time. The partial sums are output-major and reduced by
//   reduce_partials_om.
// * bc3d writes only the faces, in place. With the reference's order (x
//   faces on interior y and z, then y faces on interior z, then z faces)
//   every face cell ends up holding u(clamp(z), clamp(y), clamp(x)), where
//   clamp maps 0 to 1 and n-1 to n-2: an interior cell that no thread
//   writes, so one kernel does the whole copy without a race. Its bytes are
//   the faces', not the volume's.
// * Scalars (s_j, bs, q_i, c_i) are read from a device buffer, and the
//   reductions are two-stage and deterministic (lz_common.cuh).
// * pass2's norm-only form (no column, no field written) gives ||W_0||^2,
//   which scales the run's first pass1_3d, with pass2's grid-stride map
//   and reduction order, so the start norm of a lane does not depend on
//   the batch around it.
// * A batch of B fields (the datagen engine's lanes, JAX's vmap of the
//   Pallas kernels) is one launch of pass1_3d (lane on blockIdx.z), pass2,
//   pipe_3d or bc3d (lane on blockIdx.y; pipe_3d's lanes keep one lane's
//   grid of bricks): fields are (B, P, R, nx) lane-major, the
//   scalars and the aniso weights come per lane, and each lane keeps the
//   unbatched grid's block map and its own partial sums, reduced in the
//   unbatched order. So lane b of a batched launch gives the bits of the
//   unbatched launch on lane b. A launch of one lane takes an instantiation
//   without the lane offsets (LANES = false): with them, at the same
//   register counts, the one-lane pass2 <P=2, 8> read 16% and pass1_3d
//   5-7% slower at 128^3 (PERF.md).
// * pass1_shard3d (the shard modes) marches z through bricks of a y-x tile
//   whose width follows the block's (4 to 64 columns), so every thread
//   owns points however narrow the shard: pass1_3d's one thread per column
//   left half of each block idle at the 64 columns of 256^3 on (1, 1, 4).
//   The planes of W_j (with the halos at the block's edges, and the aniso
//   face weights) come by cp.async into a ring in shared memory, the next
//   plane in flight while the current one is stencilled, so each element
//   of W_j is read from device memory once and the neighbours from shared
//   memory; the other columns stream with 16-byte loads (a scalar form of
//   the same kernel takes nx % 4 != 0). A lane's pointers live in shared
//   memory, so one kernel serves one lane and a batch (lane on blockIdx.y)
//   at the same registers: the parent's batched form offset them at its
//   start and held them in registers (72-79 against 40-56, PERF.md).
//
// Plain C interface for ctypes: every launcher returns cudaGetLastError().

#include "lz_common.cuh"
#include "lz_stencil.cuh"
#include "lz_tile.cuh"

namespace {

// Blocks of the pass2 grid-stride loop: about 16 blocks of TX threads on
// each of the H100's 132 SMs.
constexpr int PASS2_BLOCKS = 132 * 16;

// ------------------------------------------------------------ pass1_3d
// MAXW bounds j (the number of earlier columns) so the per-column
// accumulators stay in registers.
// A batched launch (LANES) runs lane blockIdx.z with the unbatched tile
// map: its fields prev.ls floats apart, its scalars, face weights and
// partial rows lane-major. A launch of one lane takes LANES = false, the
// code without the lane offsets (the header).
template <int P, int MAXW, int MODE, bool LANES>
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
  const size_t off = LANES ? blockIdx.z * prev.ls : 0;
  if (LANES) {
    wj += off;
    w_out += off;
    if (j > 0) wjm1 += off;
    if (wt.wx != nullptr) {
      wt.wx += blockIdx.z * plane;
      wt.wy += blockIdx.z * plane;
      wt.wz += blockIdx.z * plane;
    }
    partial += (size_t)blockIdx.z * gridDim.y * gridDim.x * 2 * (j + 1);
    scal += 2 * blockIdx.z;
  }
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

// ------------------------------------------------------------ pass1_shard3d
// K9-K12 and K1' shard3d / shard3d_aniso: pass1 (w = s_j A(W_j) -
// bs W_{j-1}, raw_i = <W_i, w>) on one shard's (nz, ny, nx) block, its
// neighbours outside the block from the halos (lz_stencil.cuh's Shard3d).
//
// A block owns a brick: a tile of nxt columns by tyt rows of y, over pz
// planes of z, and marches z through it, one plane per step. Thread t owns
// row t / (nxt / 4) of the tile and four of its columns: 4f..4f+3 as one
// 16-byte vector (VEC = 4) or f, f + nxt/4, f + nxt/2, f + 3nxt/4 (VEC =
// 1), f = t % (nxt / 4). The wrapper picks nxt from the block's width (4 to
// 64 columns, lanczos3d.py shard3d_tiles), so every thread of a block owns
// points at any width; masked points fall only at the tile's ragged end.
//
// The planes of W_j come into a ring of three planes in shared memory, each
// with a one-cell frame: the tile's tyt + 2 rows and nxt + 2 columns, the
// frame from the block or, at the block's edges, from the halos (corners
// are not needed). The ANISO face weights of the plane stencilled come into
// one plane each, wx with the column left of the tile and wy with the row
// above it, and wz into a pair that also holds the plane below (at the
// block's edges wxl, wyh, wzh). The copies are cp.async, each thread
// copying its own points (fill_field, fill_weights). Step k of a brick:
// wait for its copies, one barrier, stencil plane z from the ring (each
// neighbour and weight row read just before its term, aniso one term at a
// time over the planes, so few registers), a second barrier, start
// the copies of plane z+2 (into the slot of plane z-1) and of the next
// plane's weights, then the global part while they land. So every element
// of W_j is read from device memory once (the frame's rows and planes come
// from L2: neighbouring tiles read them at about the same time; bricks
// march up (even brick) or down (odd) in z, so two bricks that share a halo
// plane read it at about the same time). Only the fill reads the halos and
// edge weights. The ring of three planes (and the weights' four) keeps a
// c(x) block of 256 threads at 52 KB, so three fit on an SM, as many as
// its registers allow (a ring of four took 103 KB: two blocks, PERF.md).
//
// W_{j-1} and W_0..W_{j-2} stream at the stencilled points with 16-byte
// loads (VEC = 4) for the -bs W_{j-1} term and the dots; W_{j-1} is loaded
// once for both, and w is stored after the dots, so that no load waits
// behind a store. A lane's pointers (lane blockIdx.y of a batched launch,
// lane 0 alone) are computed once by the block's first thread into shared
// memory and read there where they are used, so they hold no register
// across the walk, and one kernel serves one lane and a batch: lane b runs
// the one-lane tile map and reduces its own partial rows in the one-lane
// order, so it gives the bits of the launch on lane b alone.
constexpr int ST = 256;                   // most threads of a block
constexpr int SMEM_MAX = 232448 - 8192;   // the ring's most bytes: 227 KB
                                          // less room for the static arrays

// Floats of a ring row: the tile's nxt columns and a side column on each
// side; the 16-byte form starts the tile at float 4 so that every row
// stays 16-byte aligned.
inline int shard_sw(int vec, int nxt) { return vec == 4 ? nxt + 8 : nxt + 2; }

// Bytes of the ring: three planes of P field planes and, aniso, four weight
// planes (wx, wy, wz of two planes), each of tyt + 2 rows.
inline int shard_smem(int P, bool aniso, int vec, int nxt, int tyt) {
  return (3 * P + (aniso ? 4 : 0)) * (tyt + 2) * shard_sw(vec, nxt)
         * (int)sizeof(float);
}

// Bricks of one lane (= its partial-sum rows): x tiles fastest, then y
// tiles, then z.
inline int shard_tiles(int nz, int ny, int nx, int nxt, int tyt, int pz) {
  return ((nx + nxt - 1) / nxt) * ((ny + tyt - 1) / tyt)
         * ((nz + pz - 1) / pz);
}

// A lane's inputs, in shared memory (see above).
struct ShardLane {
  const float* wj;
  const float* wjm1;                 // W_{j-1}, j > 0
  float* w;
  const float* yh;
  const float* zh;
  const float* xh;
  const float* wx;
  const float* wy;
  const float* wz;
  const float* wxl;
  const float* wyh;
  const float* wzh;
  const float* wp[MAXCOLS];          // W_0..W_{j-1}
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The tile column of a thread's point e.
template <int VEC>
__device__ __forceinline__ int scol(int f, int tpr, int e) {
  return VEC == 4 ? 4 * f + e : f + tpr * e;
}

// A thread's four points of a ring row p (p: the row's column 0).
template <int VEC>
__device__ __forceinline__ void lds_row(const float* p, int f, int tpr,
                                        float (&v)[4]) {
  if (VEC == 4) {
    const float4 t = reinterpret_cast<const float4*>(p)[f];
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = p[f + tpr * e];
  }
}

// The left (x - 1) neighbours of a thread's points v of ring row p: by a
// shuffle inside the row's tpr threads (VEC = 4; the row's first thread
// reads the side column), or from the ring.
template <int VEC>
__device__ __forceinline__ void lds_left(const float* p, const float (&v)[4],
                                         int f, int tpr, float (&lf)[4]) {
  if (VEC == 4) {
    float l = __shfl_up_sync(0xffffffffu, v[3], 1, tpr);
    if (f == 0) l = p[-1];
    lf[0] = l; lf[1] = v[0]; lf[2] = v[1]; lf[3] = v[2];
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) lf[e] = p[f + tpr * e - 1];
  }
}

// The right (x + 1) neighbours, as lds_left (the row's last thread reads
// the side column at nxt).
template <int VEC>
__device__ __forceinline__ void lds_right(const float* p, const float (&v)[4],
                                          int f, int tpr, int nxt,
                                          float (&rt)[4]) {
  if (VEC == 4) {
    float r = __shfl_down_sync(0xffffffffu, v[0], 1, tpr);
    if (f == tpr - 1) r = p[nxt];
    rt[0] = v[1]; rt[1] = v[2]; rt[2] = v[3]; rt[3] = r;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) rt[e] = p[f + tpr * e + 1];
  }
}

// A thread's four points of a field row p (p: the row at the tile's first
// column, of which nv columns lie inside the block), 0 outside.
template <int VEC>
__device__ __forceinline__ void ldg_row(const float* p, int f, int tpr,
                                        int nv, float (&v)[4]) {
  if (VEC == 4) {
    if (4 * f < nv) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + f);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = f + tpr * e < nv ? __ldg(p + f + tpr * e) : 0.0f;
  }
}

template <int VEC>
__device__ __forceinline__ void stg_row(float* p, int f, int tpr, int nv,
                                        const float (&v)[4]) {
  if (VEC == 4) {
    if (4 * f < nv)
      reinterpret_cast<float4*>(p)[f] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (f + tpr * e < nv) p[f + tpr * e] = v[e];
  }
}

// Copies of a thread's four points of a row: src and dst at the tile's
// first column, of which nv columns lie inside the block.
template <int VEC>
__device__ __forceinline__ void cp_points(float* dst, const float* src, int f,
                                          int tpr, int nv) {
  if (VEC == 4) {
    if (4 * f < nv) cp_async16(dst + 4 * f, src + 4 * f);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (f + tpr * e < nv) cp_async4(dst + f + tpr * e, src + f + tpr * e);
  }
}

// A block's brick and the ring's layout, in shared memory (so that they
// hold no register across the walk).
struct Brick {
  int z0, z1, y0, x0, ye, xe;   // planes [z0, z1), rows [y0, ye), columns
  int nv;                       // [x0, xe), nv = xe - x0 of them
  int tpr;                      // threads per tile row
  int sw, pfl;                  // floats per ring row and per ring plane
};

// The ring's planes: the field slot of plane zp (P planes; zp >= -1), the
// weights wx and wy of the plane stencilled, wz of plane zp (a pair).
template <int P>
__device__ __forceinline__ float* field_slot(float* ring, const Brick& k,
                                             int zp) {
  return ring + ((zp + 3) % 3) * P * k.pfl;
}
template <int P>
__device__ __forceinline__ float* wz_slot(float* ring, const Brick& k,
                                          int zp) {
  return ring + (3 * P + 2 + ((zp + 2) & 1)) * k.pfl;
}

// Start the copies of field plane zp of the brick into its slot: each
// thread's own points (from W_j, or from the z halo at zp = -1, nz), and on
// a plane it stencils (zp in [z0, z1)) the frame: the threads of tile row 0
// copy the row above the tile (W_j, or the y halo at y = -1), those of tile
// row 1 the row below it (W_j, or the y halo at y = ny), those of column
// group 0 the side columns of their row (W_j, or the x halo at the block's
// sides). So the addresses are the thread's own, a few per plane.
template <int P, int VEC>
__device__ __forceinline__ void fill_field(float* slot, const ShardLane& L,
                                           const Brick& k, int ty, int f,
                                           int zp, int nz, int ny, int nx) {
  constexpr int OFF = VEC == 4 ? 4 : 1;
  const size_t plane = (size_t)nz * ny * nx;
  const int y = k.y0 + ty;
  float* row = slot + (ty + 1) * k.sw + OFF;     // the thread's ring row
  if (y < ny) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float* src = zp < 0 ? L.zh + ((size_t)2 * p * ny + y) * nx
                         : zp >= nz ? L.zh + ((size_t)(2 * p + 1) * ny + y) * nx
                                    : L.wj + p * plane
                                          + ((size_t)zp * ny + y) * nx;
      cp_points<VEC>(row + p * k.pfl, src + k.x0, f, k.tpr, k.nv);
    }
  }
  if (zp < k.z0 || zp >= k.z1) return;         // a halo plane: its tile only
  const size_t zr = (size_t)zp * ny;            // the plane's first row
  if (y < ny && f == 0) {                       // the side columns
    const size_t r = zr + y, R = (size_t)nz * ny;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float* w = L.wj + p * plane + r * nx;
      cp_async4(row + p * k.pfl - 1,
                k.x0 > 0 ? w + k.x0 - 1 : L.xh + 2 * p * R + r);
      cp_async4(row + p * k.pfl + k.nv,
                k.xe < nx ? w + k.xe : L.xh + (2 * p + 1) * R + r);
    }
  }
  if (ty == 0) {                                // the row above the tile
#pragma unroll
    for (int p = 0; p < P; ++p)
      cp_points<VEC>(slot + p * k.pfl + OFF,
                     (k.y0 > 0 ? L.wj + p * plane + (zr + k.y0 - 1) * nx
                               : L.yh + ((size_t)2 * p * nz + zp) * nx)
                         + k.x0,
                     f, k.tpr, k.nv);
  } else if (ty == 1) {                         // the row below the tile
#pragma unroll
    for (int p = 0; p < P; ++p)
      cp_points<VEC>(slot + p * k.pfl + (k.ye - k.y0 + 1) * k.sw + OFF,
                     (k.ye < ny ? L.wj + p * plane + (zr + k.ye) * nx
                                : L.yh + ((size_t)(2 * p + 1) * nz + zp) * nx)
                         + k.x0,
                     f, k.tpr, k.nv);
  }
}

// Start the copies of the aniso face weights: wx and wy of plane zq (to be
// stencilled; wx with the column left of the tile, wxl at the block's
// side; wy with the row above it, wyh at its top), when zq >= 0, and wz of
// plane zw (wzh for zw = -1).
template <int P, int VEC>
__device__ __forceinline__ void fill_weights(float* ring, const ShardLane& L,
                                             const Brick& k, int ty, int f,
                                             int zq, int zw, int ny,
                                             int nx) {
  constexpr int OFF = VEC == 4 ? 4 : 1;
  const int y = k.y0 + ty;
  float* wx = ring + 3 * P * k.pfl + OFF;
  float* wy = wx + k.pfl;
  if (y < ny) {
    cp_points<VEC>(wz_slot<P>(ring, k, zw) + (ty + 1) * k.sw + OFF,
                   (zw < 0 ? L.wzh + (size_t)y * nx
                           : L.wz + ((size_t)zw * ny + y) * nx) + k.x0,
                   f, k.tpr, k.nv);
  }
  if (zq < 0) return;
  const size_t zr = (size_t)zq * ny;
  if (y < ny) {
    const size_t r = zr + y;
    float* row = wx + (ty + 1) * k.sw;
    cp_points<VEC>(row, L.wx + r * nx + k.x0, f, k.tpr, k.nv);
    cp_points<VEC>(wy + (ty + 1) * k.sw, L.wy + r * nx + k.x0, f, k.tpr,
                   k.nv);
    if (f == 0)
      cp_async4(row - 1, k.x0 > 0 ? L.wx + r * nx + k.x0 - 1 : L.wxl + r);
  }
  if (ty == 0)
    cp_points<VEC>(wy, (k.y0 > 0 ? L.wy + (zr + k.y0 - 1) * nx
                                 : L.wyh + (size_t)zq * nx) + k.x0,
                   f, k.tpr, k.nv);
}

// MAXW bounds j so the per-column accumulators stay in registers. Grid:
// (bricks of one lane, lanes); (nxt / 4) tyt threads; dynamic shared memory
// shard_smem. partial: (lanes, bricks, 2 (j + 1)), raw_i at (2i, 2i+1).
// Blocks per SM the instantiations are compiled for: three (80 registers:
// an SM's four schedulers share its 65536 registers among 24 warps) for the
// 16-byte forms up to 8 columns, the datagen and main paths' (at two the
// c(x) form read 0.67 of its bound against 0.77, PERF.md), two (128) for
// the scalar forms and 16 columns, one for 32. Left to itself ptxas held
// some forms to 80 registers and spilled.
template <int MAXW, int VEC>
constexpr int SHARD_PER_SM =
    MAXW <= 8 ? (VEC == 4 ? 3 : 2) : MAXW == 16 && VEC == 4 ? 2 : 1;

template <int P, int MAXW, int MODE, int VEC>
__global__ void __launch_bounds__(ST, (SHARD_PER_SM<MAXW, VEC>))
    pass1_shard3d_kernel(const float* __restrict__ scal, const float* wj,
                         Cols prev, int j, Weights wt, Shard3d sh,
                         float* w_out, float* __restrict__ partial, int nz,
                         int ny, int nx, float ss, int nxt, int tyt, int pz) {
  constexpr bool AN = MODE == SHARD_ANISO;
  constexpr int OFF = VEC == 4 ? 4 : 1;
  extern __shared__ __align__(16) float ring[];
  __shared__ float red[ST / 32][RED_W];
  __shared__ ShardLane L;
  const int R = nz * ny;
  const size_t plane = (size_t)R * nx;
  if (threadIdx.x == 0) {
    const size_t b = blockIdx.y, ls = prev.ls;
    L.wj = wj + b * ls;
    L.w = w_out + b * ls;
    L.wjm1 = nullptr;
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      if (i < j) {
        L.wp[i] = prev.p[i] + b * ls;
        if (i == j - 1) L.wjm1 = prev.p[i] + b * ls;
      }
    }
    L.yh = sh.yh + b * 2 * P * nz * nx;
    L.zh = sh.zh + b * 2 * P * ny * nx;
    L.xh = sh.xh + b * 2 * P * R;
    if (AN) {
      L.wx = wt.wx + b * plane;
      L.wy = wt.wy + b * plane;
      L.wz = wt.wz + b * plane;
      L.wxl = sh.wxl + b * R;
      L.wyh = sh.wyh + b * nz * nx;
      L.wzh = sh.wzh + b * ny * nx;
    }
  }
  __shared__ Brick bk;
  if (threadIdx.x == 0) {
    const int ntx = (nx + nxt - 1) / nxt, nty = (ny + tyt - 1) / tyt;
    const int zc = blockIdx.x / (ntx * nty);
    const int txy = blockIdx.x - zc * (ntx * nty);
    const int ty0 = txy / ntx;
    bk.y0 = ty0 * tyt;
    bk.x0 = (txy - ty0 * ntx) * nxt;
    bk.z0 = zc * pz;
    bk.z1 = min(bk.z0 + pz, nz);
    bk.ye = min(bk.y0 + tyt, ny);
    bk.xe = min(bk.x0 + nxt, nx);
    bk.nv = bk.xe - bk.x0;
    bk.tpr = nxt / 4;
    bk.sw = VEC == 4 ? nxt + 8 : nxt + 2;
    bk.pfl = (tyt + 2) * bk.sw;
  }
  const float s = scal[2 * blockIdx.y], bs = scal[2 * blockIdx.y + 1];
  const int tpr = nxt / 4, sw = VEC == 4 ? nxt + 8 : nxt + 2;
  const int pfl = (tyt + 2) * sw;
  const int ty = threadIdx.x / tpr, f = threadIdx.x - ty * tpr;
  const int cr = (ty + 1) * sw + OFF;          // the thread's row, column 0
  __syncthreads();                             // L, bk
  const int y = bk.y0 + ty;
  const int dz = ((bk.z0 / pz) & 1) == 0 ? 1 : -1;   // up in z, or down
  const int zf = dz > 0 ? bk.z0 : bk.z1 - 1;   // the first plane stencilled
  for (int k = -1; k <= 1; ++k)
    fill_field<P, VEC>(field_slot<P>(ring, bk, zf + k * dz), L, bk, ty, f,
                       zf + k * dz, nz, ny, nx);
  if (AN) {
    fill_weights<P, VEC>(ring, L, bk, ty, f, zf, zf, ny, nx);
    fill_weights<P, VEC>(ring, L, bk, ty, f, -1, zf - 1, ny, nx);
  }
  cp_async_commit();

  float acc[MAXW][2] = {};
  float accj[2] = {0.0f, 0.0f};
  const int nzs = bk.z1 - bk.z0;
  for (int k = 0; k < nzs; ++k) {
    const int z = zf + k * dz;
    cp_async_wait_all();
    __syncthreads();             // plane z + dz and z's weights landed
    const float* sc = field_slot<P>(ring, bk, z) + cr;
    const float* slo = field_slot<P>(ring, bk, z - 1) + cr;   // plane z - 1
    const float* shi = field_slot<P>(ring, bk, z + 1) + cr;   // plane z + 1
    // K9's order of terms (iso: up + dn + zu + zd + lf + rt + diag c, the
    // diagonal from the global coordinates) and K10's (aniso: fx - fx_l +
    // fy - fy_m1 + fz - fz_m), each neighbour row read from the ring just
    // before its term; aniso takes one term at a time over the planes, so
    // that each weight row is read once and few rows are held at once
    float cv[P][4], wv[P][4], nb[4];
#pragma unroll
    for (int p = 0; p < P; ++p) lds_row<VEC>(sc + p * pfl, f, tpr, cv[p]);
    if (AN) {
      const float* px = ring + 3 * P * pfl + cr;     // wx, then wy
      const float* py = px + pfl;
      float kw[4], kl[4];
      lds_row<VEC>(px, f, tpr, kw);
      lds_left<VEC>(px, kw, f, tpr, kl);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        lds_right<VEC>(sc + p * pfl, cv[p], f, tpr, nxt, nb);
#pragma unroll
        for (int e = 0; e < 4; ++e) wv[p][e] = kw[e] * (nb[e] - cv[p][e]);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        lds_left<VEC>(sc + p * pfl, cv[p], f, tpr, nb);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wv[p][e] = wv[p][e] - kl[e] * (cv[p][e] - nb[e]);
      }
      lds_row<VEC>(py, f, tpr, kw);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        lds_row<VEC>(sc + p * pfl + sw, f, tpr, nb);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wv[p][e] = wv[p][e] + kw[e] * (nb[e] - cv[p][e]);
      }
      lds_row<VEC>(py - sw, f, tpr, kw);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        lds_row<VEC>(sc + p * pfl - sw, f, tpr, nb);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wv[p][e] = wv[p][e] - kw[e] * (cv[p][e] - nb[e]);
      }
      lds_row<VEC>(wz_slot<P>(ring, bk, z) + cr, f, tpr, kw);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        lds_row<VEC>(shi + p * pfl, f, tpr, nb);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wv[p][e] = wv[p][e] + kw[e] * (nb[e] - cv[p][e]);
      }
      lds_row<VEC>(wz_slot<P>(ring, bk, z - 1) + cr, f, tpr, kw);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        lds_row<VEC>(slo + p * pfl, f, tpr, nb);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wv[p][e] = (wv[p][e] - kw[e] * (cv[p][e] - nb[e])) * ss;
      }
    } else {
      const int gz = sh.z0 + z, gy = sh.y0 + y;
      const int zy = (gz == 0) + (gz == sh.NZ - 1) + (gy == 0)
                     + (gy == sh.NY - 1);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* pc = sc + p * pfl;
        float(&a)[4] = wv[p];
        lds_row<VEC>(pc - sw, f, tpr, a);
        lds_row<VEC>(pc + sw, f, tpr, nb);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = a[e] + nb[e];
        lds_row<VEC>(slo + p * pfl, f, tpr, nb);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = a[e] + nb[e];
        lds_row<VEC>(shi + p * pfl, f, tpr, nb);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = a[e] + nb[e];
        lds_left<VEC>(pc, cv[p], f, tpr, nb);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = a[e] + nb[e];
        lds_right<VEC>(pc, cv[p], f, tpr, nxt, nb);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gx = sh.x0 + bk.x0 + scol<VEC>(f, tpr, e);
          const int n = zy + (gx == 0) + (gx == sh.NX - 1);
          const float diag = MODE == SHARD_REF ? (n ? -5.0f : -6.0f)
                                               : -(6.0f - (float)n);
          a[e] = (a[e] + nb[e] + diag * cv[p][e]) * ss;
        }
      }
    }
    __syncthreads();             // the ring's reads of this step are done
    if (k + 1 < nzs) {
      fill_field<P, VEC>(field_slot<P>(ring, bk, z + 2 * dz), L, bk, ty, f,
                         z + 2 * dz, nz, ny, nx);
      if (AN)
        fill_weights<P, VEC>(ring, L, bk, ty, f, z + dz,
                             dz > 0 ? z + 1 : z - 2, ny, nx);
    }
    cp_async_commit();
    if (y >= ny) continue;       // a row past the block's ragged end
    const int nv = bk.nv;
    const size_t rb = ((size_t)z * ny + y) * nx + bk.x0;
    // w and the dots first, the stores of w after them: no load waits
    // behind a store
    float wm[P][4];              // W_{j-1} at the points
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (j > 0) ldg_row<VEC>(L.wjm1 + p * plane + rb, f, tpr, nv, wm[p]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = scol<VEC>(f, tpr, e) < nv;
        float v = s * wv[p][e];
        if (j > 0) v = v - bs * wm[p][e];
        wv[p][e] = in ? v : 0.0f;
        cv[p][e] = in ? cv[p][e] : 0.0f;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a[P], b[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        a[p] = cv[p][e];
        b[p] = wv[p][e];
      }
      hdot<P>(a, b, accj);
    }
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
      if (i < j) {
        float wl[P][4];
        if (i == j - 1) {
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) wl[p][e] = wm[p][e];
        } else {
          const float* wi = L.wp[i];
#pragma unroll
          for (int p = 0; p < P; ++p)
            ldg_row<VEC>(wi + p * plane + rb, f, tpr, nv, wl[p]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float a[P], b[P];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            a[p] = wl[p][e];
            b[p] = wv[p][e];
          }
          hdot<P>(a, b, acc[i]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      stg_row<VEC>(L.w + p * plane + rb, f, tpr, nv, wv[p]);
  }
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i < j) {
      put(red, 2 * i, acc[i][0]);
      put(red, 2 * i + 1, acc[i][1]);
    }
  }
  put(red, 2 * j, accj[0]);
  put(red, 2 * j + 1, accj[1]);
  write_partials_n(red, blockDim.x / 32, 2 * (j + 1),
                   (size_t)blockIdx.y * gridDim.x + blockIdx.x, partial);
}

// ------------------------------------------------------------ pass2
// MAXW bounds nw = j + 1 so the coefficients stay in registers. A batched
// launch (LANES) runs lane blockIdx.y with the unbatched grid-stride map:
// its fields W.ls floats apart, its q 2 nw floats apart, its partial row
// lane-major (write_partials); a launch of one lane takes LANES = false,
// the code without the lane offsets (as pass1_3d). STORE false is the
// norm-only form (nw = 0): ||w||^2 and no field written.
template <int P, int MAXW, bool STORE, bool LANES>
__global__ void __launch_bounds__(TX) pass2_kernel(
    const float* __restrict__ q, const float* __restrict__ w, Cols W, int nw,
    float* __restrict__ wn_out, float* __restrict__ partial, size_t n) {
  __shared__ float red[NWARP][RED_W];
  const size_t off = LANES ? blockIdx.y * W.ls : 0;
  if (LANES) {
    w += off;
    if (STORE) wn_out += off;
    q += (size_t)blockIdx.y * 2 * nw;
  }
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
        const float w0 = __ldg(W.p[i] + off + e);
        if (P == 1) {
          a0 = a0 - cf[i][0] * w0;
        } else {
          const float w1 = __ldg(W.p[i] + off + n + e);
          a0 = a0 - (cf[i][0] * w0 - cf[i][1] * w1);
          a1 = a1 - (cf[i][0] * w1 + cf[i][1] * w0);
        }
      }
    }
    if (STORE) wn_out[e] = a0;
    nsq += a0 * a0;
    if (P == 2) {
      if (STORE) wn_out[n + e] = a1;
      nsq += a1 * a1;
    }
  }
  put(red, 0, nsq);
  write_partials(red, 1, partial);
}

// ------------------------------------------------------------ pipe_3d
// K8: one pipelined iteration j on the 3D operators, one pipe pass of
// lz_tile.cuh (K2's row layout, halo columns, shuffles and lane-group
// dots) on bricks of the merged view. A brick is PX columns by TY3 rows of
// y by pz planes of z; a fixed grid of resident blocks walks the bricks in
// a fixed order, and the wrapper picks pz per grid so that the busiest
// block takes the fewest plane steps.
//
// Step k of a brick rebuilds plane zr_k: warp w rebuilds row w of its
// TY3 + 2 rows (the halo rows are the merged rows z ny + y0 - 1 and
// z ny + y0 + TY3, so the reference operator's y-seam and the boundaries
// come from the merged row index, as in pass1_3d) into slot k % RING3 of a
// ring of planes in shared memory. One __syncthreads. Then warp w
// stencils row w of the plane rebuilt at step k - 1 from the ring (its
// neighbours in z are the planes of steps k - 2 and k) and takes its dots:
// gram_i and d_i from one load of W_i. A step's stencil reads three slots
// while the next step writes the fourth, so the ring needs one barrier per
// step.
//
// The dots read W_i a second time, one step after the rebuild read it: the
// rows all blocks touch in one step (8 rows of j + 2 columns each) must
// stay in L2 for that second read to come from there. Bricks of 6 rows
// keep them at ~21 MB at 128^3, m = 10, and read faster than taller ones
// (14 to 30 rows; PERF.md). Bricks march up in z (even brick index) or
// down (odd), so two bricks that share a halo plane rebuild it at about the
// same time.
constexpr int TY3 = PWARP - 2;        // brick rows: one rebuilt row per warp
constexpr int RING3 = 4;              // planes in the ring

// The face weights of the ANISO operator at a lane's four points of merged
// row r (plane z): k = (wx, wx at x-1, wy, wy at r-1, wz, wz at z-1), 0
// where that face lies outside the grid.
template <int VEC>
__device__ __forceinline__ void aniso3d_coef(const Weights& wt, int r, int z,
                                             int x0, int ny, int nx,
                                             size_t base, int nv, int lane,
                                             float (&k)[6][4]) {
  ldv<VEC>(wt.wx + base, lane, nv, k[0]);
  ldv<VEC>(wt.wy + base, lane, nv, k[2]);
  ldv<VEC>(wt.wz + base, lane, nv, k[4]);
  if (r > 0)
    ldv<VEC>(wt.wy + base - nx, lane, nv, k[3]);
  else
    k[3][0] = k[3][1] = k[3][2] = k[3][3] = 0.0f;
  if (z > 0)
    ldv<VEC>(wt.wz + base - (size_t)ny * nx, lane, nv, k[5]);
  else
    k[5][0] = k[5][1] = k[5][2] = k[5][3] = 0.0f;
  if (VEC == 4) {
    float left = __shfl_up_sync(0xffffffffu, k[0][3], 1);
    if (lane == 0) left = x0 > 0 ? __ldg(wt.wx + base - 1) : 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) k[1][e] = e == 0 ? left : k[0][e - 1];
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = vcol<VEC>(lane, e);
      k[1][e] = x0 + c > 0 && c < nv ? __ldg(wt.wx + base + c - 1) : 0.0f;
    }
  }
}

// MAXW bounds nw = j + 1. partial: output-major, as K2's.
// A batched launch (LANES) runs lane blockIdx.y with the unbatched brick
// walk: its fields W.ls floats apart, its scalars, face weights and
// partial rows lane-major. A launch of one lane takes LANES = false.
template <int P, int MAXW, int MODE, int VEC, bool LANES>
__global__ void __launch_bounds__(
    PT, VEC == 4 && (P == 2 || MAXW < 32) ? 2 : 1) pipe3d_kernel(
    const float* __restrict__ scal, const float* __restrict__ av, Cols W,
    int nw, Weights wt, float* __restrict__ wn_out,
    float* __restrict__ av_out, float* __restrict__ partial, int nz, int ny,
    int nx, float ss, int pz) {
  constexpr int NG = MAXW / 4;        // dot groups per warp
  constexpr int L = 32 / NG;          // lanes per dot group
  __shared__ __align__(16) float ring[RING3][PWARP][P][PX];
  __shared__ float hal[RING3][PWARP][P][2];
  __shared__ __align__(16) float avb[PWARP][P][PX];
  __shared__ float red[PWARP][RED_W];
  __shared__ float cf[2 * MAXW];
  __shared__ const float* wp[MAXW];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int q = lane / L, gl = lane % L;
  const int R = nz * ny;
  const size_t plane = (size_t)R * nx;
  const size_t off = LANES ? blockIdx.y * W.ls : 0;
  if (LANES) {
    av += off;
    wn_out += off;
    av_out += off;
    if (wt.wx != nullptr) {
      wt.wx += blockIdx.y * plane;
      wt.wy += blockIdx.y * plane;
      wt.wz += blockIdx.y * plane;
    }
    scal += (size_t)blockIdx.y * 2 * (nw + 1);
    partial += (size_t)blockIdx.y * (1 + 2 * nw + 2 * (nw + 1)) * gridDim.x;
  }
  const float s = scal[0];
  for (int o = threadIdx.x; o < 2 * nw; o += PT) cf[o] = scal[2 + o];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < MAXW; ++i)
      if (i < nw) wp[i] = W.p[i] + off;
  }
  __syncthreads();
  float nsq = 0.0f;
  float g[4][2] = {}, d[4][2] = {};
  float dl[2] = {0.0f, 0.0f};        // d_{j+1} = <W_{j+1}, av_{j+1}>
  const RebuildRows<P, VEC, LdNC> src = {av, wp, cf, nw, s, plane};
  const int ntx = (nx + PX - 1) / PX, nty = (ny + TY3 - 1) / TY3;
  const int ntiles = ntx * nty * ((nz + pz - 1) / pz);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tz = tile / (ntx * nty), txy = tile - tz * ntx * nty;
    const int y0 = (txy / ntx) * TY3, x0 = (txy % ntx) * PX;
    const int z0 = tz * pz, z1 = min(z0 + pz, nz);
    const int tyv = min(TY3, ny - y0);
    const int nv = nx - x0;
    const bool upward = (tz & 1) == 0;
    for (int k = 0; k < z1 - z0 + 2; ++k) {
      const int zr = upward ? z0 - 1 + k : z1 - k;   // the plane rebuilt
      const int slot = k % RING3;
      if (w < tyv + 2) {                             // rebuilt row w
        const int rh = zr * ny + y0 - 1 + w;         // its merged row
        float v[P][4], h[P];
        const bool left = lane == 0, edge = left || lane == 31;
        if (zr >= 0 && zr < nz && rh >= 0 && rh < R) {
          const size_t base = (size_t)rh * nx + x0;
          const long hoff = left ? -1 : PX;
          const bool hin = edge && x0 + hoff >= 0 && x0 + hoff < nx;
          src.row(base, nv, lane, hin, hoff, v, h);
          if (zr >= z0 && zr < z1 && w >= 1 && w <= tyv) {
#pragma unroll
            for (int p = 0; p < P; ++p) {
              stv<VEC>(wn_out + p * plane + base, lane, nv, v[p]);
#pragma unroll
              for (int e = 0; e < 4; ++e) nsq += v[p][e] * v[p][e];
            }
          }
        } else {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            v[p][0] = v[p][1] = v[p][2] = v[p][3] = 0.0f;
            h[p] = 0.0f;
          }
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
          sts<VEC>(ring[slot][w][p], lane, v[p]);
          if (edge) hal[slot][w][p][left ? 0 : 1] = h[p];
        }
      }
      __syncthreads();
      if (k < 2 || w >= tyv) continue;
      const int zs = upward ? zr - 1 : zr + 1;       // the plane stencilled
      const int sc = (k - 1) % RING3;
      const int slo = upward ? (k - 2) % RING3 : slot;   // plane zs - 1
      const int shi = upward ? slot : (k - 2) % RING3;   // plane zs + 1
      const int y = y0 + w;
      const int r = zs * ny + y;
      const size_t base = (size_t)r * nx + x0;
      float kw[MODE == ANISO ? 6 : 1][4];
      if constexpr (MODE == ANISO)
        aniso3d_coef<VEC>(wt, r, zs, x0, ny, nx, base, nv, lane, kw);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* cr = ring[sc][w + 1][p];
        float cv[4], lf[4], rt[4], nb[4], a[4];
        lds<VEC>(cr, lane, cv);
        row_sides<VEC>(cr, cv, hal[sc][w + 1][p], lane, lf, rt);
        if constexpr (MODE == ANISO) {
          // stencil3d_vals's order of terms, each neighbour row read from
          // the ring just before its term
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a[e] = kw[0][e] * (rt[e] - cv[e]);
            if (x0 + vcol<VEC>(lane, e) > 0)
              a[e] = a[e] - kw[1][e] * (cv[e] - lf[e]);
          }
          lds<VEC>(ring[sc][w + 2][p], lane, nb);
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = a[e] + kw[2][e] * (nb[e] - cv[e]);
          if (r > 0) {
            lds<VEC>(ring[sc][w][p], lane, nb);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              a[e] = a[e] - kw[3][e] * (cv[e] - nb[e]);
          }
          lds<VEC>(ring[shi][w + 1][p], lane, nb);
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = a[e] + kw[4][e] * (nb[e] - cv[e]);
          if (zs > 0) {
            lds<VEC>(ring[slo][w + 1][p], lane, nb);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              a[e] = a[e] - kw[5][e] * (cv[e] - nb[e]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = a[e] * ss;
        } else {
          float up[4], dn[4], zu[4];
          lds<VEC>(ring[sc][w][p], lane, up);
          lds<VEC>(ring[sc][w + 2][p], lane, dn);
          lds<VEC>(ring[slo][w + 1][p], lane, zu);
          lds<VEC>(ring[shi][w + 1][p], lane, nb);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[e] = stencil3d_vals<MODE>(cv[e], up[e], dn[e], zu[e], nb[e],
                                        lf[e], rt[e], wt, 0, r, zs, y,
                                        x0 + vcol<VEC>(lane, e), nz, ny, nx,
                                        ss);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (vcol<VEC>(lane, e) >= nv) a[e] = 0.0f;
        stv<VEC>(av_out + p * plane + base, lane, nv, a);
        sts<VEC>(avb[w][p], lane, a);
      }
      dot_last<P, VEC>(ring[sc][w + 1], avb[w], lane, dl);
      __syncwarp();
      tile_dots<P, MAXW, false, VEC, LdNC>(wp, nw, plane,
                                           &ring[sc][w + 1][0][0],
                                           &avb[w][0][0], base, nv, q, gl, g,
                                           d);
      __syncwarp();
    }
    __syncthreads();                                 // the ring is reused
  }
  pipe_partials<MAXW, false>(nsq, g, d, dl, nw, lane, w, q, gl, red, partial);
}

// One pipe3d_kernel instantiation on B lanes (lane on blockIdx.y; one lane
// without the lane offsets): the launch (fit == false) or the blocks of it
// that fit on the card at once (fit == true; the one-lane instantiation's,
// which the lanes' grid keeps).
template <int P, int MAXW, int MODE, int VEC>
int launch_pipe3d(bool fit, int B, const float* scal, const float* av,
                  Cols W, int nw, Weights wt, float* wn, float* avn,
                  float* partial, int nz, int ny, int nx, float ss, int pz,
                  int grid, cudaStream_t st) {
  if (fit) return resident_blocks(pipe3d_kernel<P, MAXW, MODE, VEC, false>,
                                  PT);
  if (B > 1)
    pipe3d_kernel<P, MAXW, MODE, VEC, true><<<dim3(grid, B), PT, 0, st>>>(
        scal, av, W, nw, wt, wn, avn, partial, nz, ny, nx, ss, pz);
  else
    pipe3d_kernel<P, MAXW, MODE, VEC, false><<<grid, PT, 0, st>>>(
        scal, av, W, nw, wt, wn, avn, partial, nz, ny, nx, ss, pz);
  return (int)cudaGetLastError();
}

// One pipe3d_kernel bucket of nw: the launch or the fit, as launch_pipe3d.
template <int P, int MODE, int VEC>
int pipe3d_bucket(bool fit, int B, int b, const float* scal, const float* av,
                  Cols W, int nw, Weights wt, float* wn, float* avn,
                  float* partial, int nz, int ny, int nx, float ss, int pz,
                  int grid, cudaStream_t st) {
#define LZ_P3(BB) launch_pipe3d<P, BB, MODE, VEC>(fit, B, scal, av, W, nw,   \
                                                  wt, wn, avn, partial, nz, \
                                                  ny, nx, ss, pz, grid, st)
  if (b == 4) return LZ_P3(4);
  if (b == 8) return LZ_P3(8);
  if (b == 16) return LZ_P3(16);
  return LZ_P3(32);
#undef LZ_P3
}

int pipe3d_any(bool fit, int B, int P, int vec, int mode, int b,
               const float* scal, const float* av, Cols W, int nw,
               Weights wt, float* wn, float* avn, float* partial, int nz,
               int ny, int nx, float ss, int pz, int grid, cudaStream_t st) {
#define LZ_A3(PP, MM, VV) pipe3d_bucket<PP, MM, VV>(                          \
    fit, B, b, scal, av, W, nw, wt, wn, avn, partial, nz, ny, nx, ss, pz,     \
    grid, st)
#define LZ_V3(PP, MM) (vec ? LZ_A3(PP, MM, 4) : LZ_A3(PP, MM, 1))
  if (P == 1)
    return mode == ISO_REF ? LZ_V3(1, ISO_REF)
           : mode == ISO_CLEAN ? LZ_V3(1, ISO_CLEAN) : LZ_V3(1, ANISO);
  return mode == ISO_REF ? LZ_V3(2, ISO_REF)
         : mode == ISO_CLEAN ? LZ_V3(2, ISO_CLEAN) : LZ_V3(2, ANISO);
#undef LZ_V3
#undef LZ_A3
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
// that are neither. Unsharded, the block is the grid. A batched launch
// copies lane blockIdx.y, P (nz, ny, nx) planes after lane 0's.
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
  u += blockIdx.y * (size_t)P * plane;
  const size_t dst = ((size_t)z * ny + y) * nx + x;
  const size_t src = ((size_t)clamp_in(z, nz, zl, zh) * ny
                      + clamp_in(y, ny, yl, yh)) * nx + clamp_in(x, nx, xl, xh);
#pragma unroll
  for (int p = 0; p < P; ++p) u[p * plane + dst] = u[p * plane + src];
}

// pass1_3d over B lanes (blockIdx.z), each lane's tiles as one unbatched
// launch's; one lane without the lane offsets.
template <int P, int MAXW, int MODE>
void launch_pass1(int B, const float* scal, const float* wj, Cols prev,
                  int j, Weights wt, float* w, float* partial, int nz, int ny,
                  int nx, float ss, cudaStream_t st) {
  dim3 g = tile_grid(nz * ny, nx);
  g.z = B;
  const float* wjm1 = j > 0 ? prev.p[j - 1] : nullptr;
  if (B > 1) {
    pass1_3d_kernel<P, MAXW, MODE, true><<<g, TX, 0, st>>>(
        scal, wj, prev, wjm1, j, wt, w, partial, nz, ny, nx, ss);
    return;
  }
  pass1_3d_kernel<P, MAXW, MODE, false><<<g, TX, 0, st>>>(
      scal, wj, prev, wjm1, j, wt, w, partial, nz, ny, nx, ss);
}

template <int P, int MODE>
void pass1_bucket(int B, int b, const float* scal, const float* wj,
                  Cols prev, int j, Weights wt, float* w, float* partial,
                  int nz, int ny, int nx, float ss, cudaStream_t st) {
#define LZ_B(BB) launch_pass1<P, BB, MODE>(B, scal, wj, prev, j, wt, w, \
                                           partial, nz, ny, nx, ss, st)
  if (b == 4) LZ_B(4);
  else if (b == 8) LZ_B(8);
  else if (b == 16) LZ_B(16);
  else LZ_B(32);
#undef LZ_B
}

template <int P>
void pass1_mode(int B, int mode, int b, const float* scal, const float* wj,
                Cols prev, int j, Weights wt, float* w, float* partial,
                int nz, int ny, int nx, float ss, cudaStream_t st) {
#define LZ_M(MM) pass1_bucket<P, MM>(B, b, scal, wj, prev, j, wt, w, \
                                     partial, nz, ny, nx, ss, st)
  switch (mode) {
    case ISO_REF: LZ_M(ISO_REF); break;
    case ISO_CLEAN: LZ_M(ISO_CLEAN); break;
    default: LZ_M(ANISO); break;
  }
#undef LZ_M
}

// pass1_3d (unsharded modes) over B lanes, then the reduction of its
// partial sums, lane by lane.
int pass1_any(int B, int P, int mode, const float* scal, const float* wj,
              const float* const* prev, int j, Weights wt, float* w,
              float* partial, float* raw, int nz, int ny, int nx, float ss,
              cudaStream_t st) {
  const Cols c = make_cols(prev, j, (size_t)P * nz * ny * nx);
  const int b = bucket(j);
  if (P == 1)
    pass1_mode<1>(B, mode, b, scal, wj, c, j, wt, w, partial, nz, ny, nx, ss,
                  st);
  else
    pass1_mode<2>(B, mode, b, scal, wj, c, j, wt, w, partial, nz, ny, nx, ss,
                  st);
  const int nout = 2 * (j + 1);
  const dim3 g = tile_grid(nz * ny, nx);
  reduce_partials<<<dim3(nout, B), RED_THREADS, 0, st>>>(
      partial, (int)(g.x * g.y), nout, raw);
  return (int)cudaGetLastError();
}

// pass1_shard3d_kernel <P, MAXW, MODE, VEC> on B lanes (blockIdx.y), nblk
// tiles each: the launch, with the dynamic shared memory of its ring.
template <int P, int MAXW, int MODE, int VEC>
int launch_shard(int B, const float* scal, const float* wj, Cols prev, int j,
                 Weights wt, const Shard3d& sh, float* w, float* partial,
                 int nz, int ny, int nx, float ss, int nxt, int tyt, int pz,
                 int nblk, cudaStream_t st) {
  auto kern = pass1_shard3d_kernel<P, MAXW, MODE, VEC>;
  const int smem = shard_smem(P, MODE == SHARD_ANISO, VEC, nxt, tyt);
  // the attribute is per device: set once for each on which it launches
  static int allowed[64] = {};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    err = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != 0) return err;
    allowed[dev] = smem;
  }
  kern<<<dim3(nblk, B), (nxt / 4) * tyt, smem, st>>>(
      scal, wj, prev, j, wt, sh, w, partial, nz, ny, nx, ss, nxt, tyt, pz);
  return (int)cudaGetLastError();
}

template <int P, int MODE, int VEC>
int shard_bucket(int B, int b, const float* scal, const float* wj, Cols prev,
                 int j, Weights wt, const Shard3d& sh, float* w,
                 float* partial, int nz, int ny, int nx, float ss, int nxt,
                 int tyt, int pz, int nblk, cudaStream_t st) {
#define LZ_S(BB) launch_shard<P, BB, MODE, VEC>(B, scal, wj, prev, j, wt, sh, \
                                               w, partial, nz, ny, nx, ss,   \
                                               nxt, tyt, pz, nblk, st)
  if (b == 4) return LZ_S(4);
  if (b == 8) return LZ_S(8);
  if (b == 16) return LZ_S(16);
  return LZ_S(32);
#undef LZ_S
}

int shard_any(int B, int P, int mode, int vec, int b, const float* scal,
              const float* wj, Cols prev, int j, Weights wt,
              const Shard3d& sh, float* w, float* partial, int nz, int ny,
              int nx, float ss, int nxt, int tyt, int pz, int nblk,
              cudaStream_t st) {
#define LZ_SA(PP, MM, VV) shard_bucket<PP, MM, VV>(                           \
    B, b, scal, wj, prev, j, wt, sh, w, partial, nz, ny, nx, ss, nxt, tyt,   \
    pz, nblk, st)
#define LZ_SV(PP, MM) (vec ? LZ_SA(PP, MM, 4) : LZ_SA(PP, MM, 1))
  if (P == 1)
    return mode == 0 ? LZ_SV(1, SHARD_REF)
           : mode == 1 ? LZ_SV(1, SHARD_CLEAN) : LZ_SV(1, SHARD_ANISO);
  return mode == 0 ? LZ_SV(2, SHARD_REF)
         : mode == 1 ? LZ_SV(2, SHARD_CLEAN) : LZ_SV(2, SHARD_ANISO);
#undef LZ_SV
#undef LZ_SA
}

template <int P, bool LANES>
void launch_pass2(int B, int b, const float* q, const float* w, Cols W,
                  int nw, float* wn, float* partial, size_t n,
                  cudaStream_t st) {
  const dim3 g(PASS2_BLOCKS, B);
  if (wn == nullptr)
    pass2_kernel<P, 4, false, LANES><<<g, TX, 0, st>>>(q, w, W, 0, nullptr,
                                                       partial, n);
  else if (b == 4)
    pass2_kernel<P, 4, true, LANES><<<g, TX, 0, st>>>(q, w, W, nw, wn,
                                                      partial, n);
  else if (b == 8)
    pass2_kernel<P, 8, true, LANES><<<g, TX, 0, st>>>(q, w, W, nw, wn,
                                                      partial, n);
  else if (b == 16)
    pass2_kernel<P, 16, true, LANES><<<g, TX, 0, st>>>(q, w, W, nw, wn,
                                                       partial, n);
  else
    pass2_kernel<P, 32, true, LANES><<<g, TX, 0, st>>>(q, w, W, nw, wn,
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

// pass1_3d on B lanes (B = 1: one field). Every field is (B, P, R, nx),
// lane-major. mode: 0 iso reference, 1 iso clean, 2 aniso (wx, wy, wz are
// (B, R, nx) device arrays, each lane its own; null otherwise). prev: host
// array of j device pointers W_0..W_{j-1} (lane 0's). scal: (B, 2) [s_j,
// bs] per lane. partial: scratch of lz3_pass1_blocks * B * 2(j+1) floats.
// raw: (B, j+1, 2) output.
int lz3_pass1(int B, int P, int mode, const float* scal, const float* wj,
              const float* const* prev, int j, const float* wx,
              const float* wy, const float* wz, float* w, float* partial,
              float* raw, int nz, int ny, int nx, float ss, cudaStream_t st) {
  if (B < 1 || B > 65535 || (P != 1 && P != 2) || mode < 0 || mode > 2
      || j < 0 || j + 1 > MAXCOLS || nz < 3 || ny < 3 || nx < 3)
    return (int)cudaErrorInvalidValue;
  if (mode == ANISO && (!wx || !wy || !wz)) return (int)cudaErrorInvalidValue;
  return pass1_any(B, P, mode, scal, wj, prev, j, Weights{wx, wy, wz}, w,
                   partial, raw, nz, ny, nx, ss, st);
}

// Tiles (= partial-sum rows) of one lane of a pass1_shard3d launch on an
// (nz, ny, nx) block in tiles of nxt columns, tyt rows and pz planes.
int lz3_shard_blocks(int nz, int ny, int nx, int nxt, int tyt, int pz) {
  if (nxt < 1 || tyt < 1 || pz < 1) return 0;
  return shard_tiles(nz, ny, nx, nxt, tyt, pz);
}

// Bytes of dynamic shared memory (the plane ring) a pass1_shard3d launch
// takes: mode as lz3_pass1_shard, vec 1 the 16-byte form.
int lz3_shard_smem(int P, int mode, int vec, int nxt, int tyt) {
  return shard_smem(P, mode == 2, vec ? 4 : 1, nxt, tyt);
}

// pass1_shard3d: pass1_3d on one shard's (nz, ny, nx) block at global
// offsets (z0, y0, x0) of an (NZ, NY, NX) grid, for B lanes (B = 1: one
// field; every lane at the same offsets). mode: 0 iso reference, 1 iso
// clean, 2 aniso (wx, wy, wz (B, R, nx), wxl (B, R), wyh (B, nz, nx), wzh
// (B, ny, nx); null otherwise). yh (B, P, 2, nz, nx), zh (B, P, 2, ny, nx),
// xh (B, P, 2, R): the halos. Tiles of nxt columns (4 to 128, a power of
// two), tyt rows and pz planes, (nxt / 4) tyt threads (a multiple of 32, at
// most 256); vec = 1 takes the 16-byte form (nx % 4 == 0 and every field,
// face weight and y / z halo 16-byte aligned). partial: scratch of
// lz3_shard_blocks * B * 2(j+1) floats. Otherwise as lz3_pass1.
int lz3_pass1_shard(int B, int P, int mode, int vec, const float* scal,
                    const float* wj, const float* const* prev, int j,
                    const float* wx, const float* wy, const float* wz,
                    const float* wxl, const float* wyh, const float* wzh,
                    const float* yh, const float* zh, const float* xh,
                    float* w, float* partial, float* raw, int nz, int ny,
                    int nx, int z0, int y0, int x0, int NZ, int NY, int NX,
                    float ss, int nxt, int tyt, int pz, cudaStream_t st) {
  const int threads = (nxt / 4) * tyt;
  if (B < 1 || B > 65535 || (P != 1 && P != 2) || mode < 0 || mode > 2
      || j < 0 || j + 1 > MAXCOLS || nz < 2 || ny < 2 || nx < 2 || !yh
      || !zh || !xh || z0 < 0 || y0 < 0 || x0 < 0 || z0 + nz > NZ
      || y0 + ny > NY || x0 + nx > NX || nxt < 4 || nxt > 128
      || (nxt & (nxt - 1)) || tyt < 1 || pz < 1
      || threads > ST || threads % 32
      || shard_smem(P, mode == 2, vec ? 4 : 1, nxt, tyt) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (mode == 2 && (!wx || !wy || !wz || !wxl || !wyh || !wzh))
    return (int)cudaErrorInvalidValue;
  bool ok = nx % 4 == 0 && aligned16(wj) && aligned16(w) && aligned16(yh)
            && aligned16(zh) && aligned16(wx) && aligned16(wy)
            && aligned16(wz) && aligned16(wyh) && aligned16(wzh);
  for (int i = 0; i < j; ++i) ok = ok && aligned16(prev[i]);
  if (vec && !ok) return (int)cudaErrorInvalidValue;
  const Shard3d sh = {yh, zh, xh, wxl, wyh, wzh, z0, y0, x0, NZ, NY, NX};
  const Cols c = make_cols(prev, j, (size_t)P * nz * ny * nx);
  const int nblk = shard_tiles(nz, ny, nx, nxt, tyt, pz);
  const int err = shard_any(B, P, mode, vec, bucket(j), scal, wj, c, j,
                            Weights{wx, wy, wz}, sh, w, partial, nz, ny, nx,
                            ss, nxt, tyt, pz, nblk, st);
  if (err != 0) return err;
  const int nout = 2 * (j + 1);
  reduce_partials<<<dim3(nout, B), RED_THREADS, 0, st>>>(partial, nblk, nout,
                                                         raw);
  return (int)cudaGetLastError();
}

// pass2 on B lanes (B = 1: one field). Every field is (B, P, n), lane-major,
// n = R * nx points per plane. q: (B, nw, 2) device buffer. W: host array
// of nw = j+1 device pointers (lane 0's). partial: scratch of
// lz3_pass2_blocks * B floats. nsq: (B,) output. The norm-only form: nw = 0
// and wn null, nsq = ||w||^2 per lane, no field written (q, W unused).
int lz3_pass2(int B, int P, const float* q, const float* w,
              const float* const* W, int nw, float* wn, float* partial,
              float* nsq, long long n, cudaStream_t st) {
  if (B < 1 || B > 65535 || (P != 1 && P != 2) || nw < 0 || nw > MAXCOLS
      || n < 1 || (nw == 0) != (wn == nullptr))
    return (int)cudaErrorInvalidValue;
  const Cols c = make_cols(W, nw, (size_t)P * n);
  const int b = bucket(nw);
#define LZ_P2(PP, LL) launch_pass2<PP, LL>(B, b, q, w, c, nw, wn, partial, \
                                          (size_t)n, st)
  if (P == 1) {
    if (B > 1) LZ_P2(1, true); else LZ_P2(1, false);
  } else {
    if (B > 1) LZ_P2(2, true); else LZ_P2(2, false);
  }
#undef LZ_P2
  reduce_partials<<<dim3(1, B), RED_THREADS, 0, st>>>(partial, PASS2_BLOCKS,
                                                      1, nsq);
  return (int)cudaGetLastError();
}

// Rows of a pipe_3d brick.
int lz3_pipe3d_rows() { return TY3; }

// Blocks of the pipe_3d instantiation that a call with P, mode, nw columns
// and vec (1: the 16-byte form) takes that fit on the card at once.
int lz3_pipe3d_fit(int P, int mode, int nw, int vec) {
  if ((P != 1 && P != 2) || mode < 0 || mode > 2 || nw < 1
      || nw + 1 > MAXCOLS)
    return 0;
  return pipe3d_any(true, 1, P, vec, mode, bucket(nw), nullptr, nullptr,
                    Cols{}, nw, Weights{}, nullptr, nullptr, nullptr, 0, 0,
                    0, 0.0f, 0, 0, nullptr);
}

// pipe_3d (K8) on B lanes (B = 1: one field). mode as lz3_pass1 (aniso
// weights (B, R, nx), each lane its own). W: host array of nw = j+1 device
// pointers W_0..W_j (lane 0's); every field is (B, P, R, nx), lane-major.
// scal: (B, nw+1, 2) device buffer [(s_j, 0), c_0..c_j] per lane. Bricks
// of PX columns, TY3 rows and pz planes, walked by `grid` blocks per lane
// (at most the blocks of PT threads an SM holds, times the SMs); vec = 1
// takes the 16-byte form (nx % 4 == 0 and every field and weight 16-byte
// aligned). partial: scratch of B * grid * nout floats; red: (B, nout)
// outputs, nout = 1 + 2 nw + 2 (nw + 1) (nsq, gram, d).
int lz3_pipe3d(int B, int P, int mode, int vec, const float* scal,
               const float* av, const float* const* W, int nw,
               const float* wx, const float* wy, const float* wz, float* wn,
               float* avn, float* partial, float* red, int nz, int ny, int nx,
               float ss, int pz, int grid, cudaStream_t st) {
  if (B < 1 || B > 65535 || (P != 1 && P != 2) || mode < 0 || mode > 2
      || nw < 1 || nw + 1 > MAXCOLS || nz < 3 || ny < 3 || nx < 3 || pz < 1
      || grid < 1 || grid > pipe_max_blocks())
    return (int)cudaErrorInvalidValue;
  if (mode == ANISO && (!wx || !wy || !wz)) return (int)cudaErrorInvalidValue;
  bool ok = nx % 4 == 0 && aligned16(av) && aligned16(wn) && aligned16(avn);
  for (int i = 0; i < nw; ++i) ok = ok && aligned16(W[i]);
  if (mode == ANISO) ok = ok && aligned16(wx) && aligned16(wy) && aligned16(wz);
  if (vec && !ok) return (int)cudaErrorInvalidValue;
  const Cols c = make_cols(W, nw, (size_t)P * nz * ny * nx);
  const int err = pipe3d_any(false, B, P, vec, mode, bucket(nw), scal, av, c,
                             nw, Weights{wx, wy, wz}, wn, avn, partial, nz,
                             ny, nx, ss, pz, grid, st);
  if (err != 0) return err;
  const int nout = 1 + 2 * nw + 2 * (nw + 1);
  reduce_partials_om<<<dim3(nout, B), RED_THREADS, 0, st>>>(partial, grid,
                                                            red);
  return (int)cudaGetLastError();
}

// bc3d: the ghost copy on the (P, nz*ny, nx) block u at global offsets
// (z0, y0, x0) of an (NZ, NY, NX) grid, in place (unsharded: offsets 0,
// the grid's shape), on each of B lanes (B, P, nz*ny, nx), lane-major. A
// block with no face cell launches nothing.
int lz3_bc3d(int B, int P, float* u, int nz, int ny, int nx, int z0, int y0,
             int x0, int NZ, int NY, int NX, cudaStream_t st) {
  if (B < 1 || B > 65535 || (P != 1 && P != 2) || nz < 2 || ny < 2 || nx < 2
      || NZ < 3 || NY < 3
      || NX < 3 || z0 < 0 || y0 < 0 || x0 < 0 || z0 + nz > NZ
      || y0 + ny > NY || x0 + nx > NX)
    return (int)cudaErrorInvalidValue;
  const long long zl = z0 == 0, zh = z0 + nz == NZ, yl = y0 == 0;
  const long long yh = y0 + ny == NY, xl = x0 == 0, xh = x0 + nx == NX;
  const long long izn = nz - zl - zh, iyn = ny - yl - yh;
  const long long cells = (zl + zh) * ny * nx + (yl + yh) * izn * nx
                          + (xl + xh) * izn * iyn;
  if (cells == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((cells + 255) / 256), B);
  if (P == 1)
    bc3d_kernel<1><<<grid, 256, 0, st>>>(u, nz, ny, nx, z0, y0, x0, NZ, NY,
                                         NX);
  else
    bc3d_kernel<2><<<grid, 256, 0, st>>>(u, nz, ny, nx, z0, y0, x0, NZ, NY,
                                         NX);
  return (int)cudaGetLastError();
}

}  // extern "C"
