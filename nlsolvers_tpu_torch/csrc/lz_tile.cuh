// The tile walker of the pipelined Lanczos kernels, shared by K2 / K2'
// (lanczos2d.cu pipe_2d_kernel), K8 (lanczos3d.cu pipe3d_kernel) and K13
// (resident2d.cu resident_kernel). Its ring, row loads, side neighbours and
// lane-group dots also carry the first phase of K1 / K1' and K5
// (lz_iter.cuh's wpass, its own row source and epilogue).
//
// One pipe pass builds a column W_{j+1} row by row, stencils it into
// av_{j+1} = A(W_{j+1}) while the rows are still in shared memory, and takes
// the dots of both against the basis:
//   ||W_{j+1}||^2, gram_i = <W_i, W_{j+1}> and d_i = <W_i, av_{j+1}> (i <= j)
//   and d_{j+1} = <W_{j+1}, av_{j+1}>.
// The rows come from a row source: RebuildRows (W_{j+1} = s av_j - sum_i
// c_i W_i, lz_common.cuh's rebuild order) or, in K13's first phase, the
// kicked field.
//
// A lane holds four points of a PX = 128-column row: cols 4f..4f+3 as one
// 16-byte vector (VEC = 4, when nx % 4 == 0 and every pointer is 16-byte
// aligned) or cols f, f+32, f+64, f+96 as scalars (VEC = 1), f = lane.
// Lanes 0 and 31 rebuild the halo columns x0 - 1 and x0 + PX of a row in the
// same pass as their own points; the stencil takes its left and right
// neighbours by warp shuffles across the 16-byte groups.
//
// For the dots a warp splits into NG = MAXW / 4 groups of 32 / NG lanes:
// group q owns the columns i = q + NG c (c < 4) and its lanes walk the row's
// 32 vectors, so a lane keeps 4 complex gram and 4 complex d sums at every
// bucket (16 registers) instead of 4 MAXW. gram_i and d_i come from ONE load
// of W_i at the stencilled row; W_{j+1} comes from the ring, av_{j+1} from a
// per-warp row buffer.
//
// 2D (pipe2d_pass): tiles of PX columns by ty = PWARP S - 2 rows (S steps of
// PWARP rows), walked by a fixed grid of resident blocks in a fixed order:
// block b takes tiles b, b + G, b + 2G, ... Step s of a tile: warp w
// rebuilds row k = PWARP s + w of the tile's ty + 2 rows (k = 0 and ty + 1
// are the halo rows) into a shared ring of RING rows; one __syncthreads;
// then warp w stencils tile row t = k - 2 and takes its dots. A step's
// stencils read rows 8s-2..8s+7 while the next step writes rows 8s+8..
// 8s+15: 18 rows, so a ring of 24 needs one barrier per step. LAST (no
// stencil): warp w rebuilds tile rows w, w + 8, ... and takes the norm and
// gram dots; no ring across rows and no block barrier.
//
// Partial sums are stored output-major, partial[o * gridDim.x + block], in
// the layout nsq | gram_i (re, im), i < nw | d_i (re, im), i <= nw, and
// reduced in a fixed order (reduce_partials_om, or lz_iter.cuh's reduce_all
// inside a cooperative launch): no atomics, the same bits on every run.
//
// The load policy LD (lz_stencil.cuh) is LdNC for fields no block writes
// during the launch and LdL2 for K13's basis, which the same cooperative
// launch wrote before a grid sync.

#pragma once

#include "lz_common.cuh"
#include "lz_stencil.cuh"

namespace {

constexpr int PT = 256;               // threads per pipe block
constexpr int PWARP = PT / 32;        // rows per step
constexpr int PX = 128;               // columns per tile: 32 lanes x 4
constexpr int RING = 24;              // 2D ring rows (see above)

template <int VEC>
__device__ __forceinline__ int vcol(int f, int e) {
  return VEC == 4 ? 4 * f + e : f + 32 * e;
}

// v[e] = p[vcol(f, e)] where vcol(f, e) < nv (inside the grid), else 0.
template <int VEC, class LD = LdNC>
__device__ __forceinline__ void ldv(const float* __restrict__ p, int f,
                                    int nv, float (&v)[4]) {
  if (VEC == 4) {
    if (4 * f < nv) {
      const float4 t = LD::ld4(reinterpret_cast<const float4*>(p) + f);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = f + 32 * e < nv ? LD::ld(p + f + 32 * e) : 0.0f;
  }
}

template <int VEC>
__device__ __forceinline__ void stv(float* __restrict__ p, int f, int nv,
                                    const float (&v)[4]) {
  if (VEC == 4) {
    if (4 * f < nv)
      reinterpret_cast<float4*>(p)[f] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (f + 32 * e < nv) p[f + 32 * e] = v[e];
  }
}

// The same layout in shared memory (a whole PX row, no mask).
template <int VEC>
__device__ __forceinline__ void lds(const float* p, int f, float (&v)[4]) {
  if (VEC == 4) {
    const float4 t = reinterpret_cast<const float4*>(p)[f];
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = p[f + 32 * e];
  }
}

template <int VEC>
__device__ __forceinline__ void sts(float* p, int f, const float (&v)[4]) {
  if (VEC == 4) {
    reinterpret_cast<float4*>(p)[f] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) p[f + 32 * e] = v[e];
  }
}

// W_{j+1} = s av_j - sum_i c_i W_i at a lane's four points of one row
// (base: the offset of the row's first tile column, of which nv columns lie
// inside the grid) and, where hin, at the halo column hoff columns from
// there: rebuild's order of operations (lz_common.cuh), the basis pointers
// and coefficients from shared memory.
template <int P, int VEC, class LD = LdNC>
__device__ __forceinline__ void rebuild_row(
    const float* __restrict__ av, const float* const* wp, const float* cf,
    int nw, float s, size_t base, int nv, size_t plane, int lane, bool hin,
    long hoff, float (&v)[P][4], float (&h)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    ldv<VEC, LD>(av + p * plane + base, lane, nv, v[p]);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[p][e] = s * v[p][e];
    h[p] = hin ? s * LD::ld(av + p * plane + base + hoff) : 0.0f;
  }
#pragma unroll 4
  for (int i = 0; i < nw; ++i) {
    const float cr = cf[2 * i], ci = cf[2 * i + 1];
    const float* __restrict__ wi = wp[i];
    float w[P][4], hw[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ldv<VEC, LD>(wi + p * plane + base, lane, nv, w[p]);
      hw[p] = hin ? LD::ld(wi + p * plane + base + hoff) : 0.0f;
    }
    if (P == 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[0][e] = v[0][e] - cr * w[0][e];
      h[0] = h[0] - cr * hw[0];
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a0 = v[0][e] - (cr * w[0][e] - ci * w[P - 1][e]);
        v[P - 1][e] = v[P - 1][e] - (cr * w[P - 1][e] + ci * w[0][e]);
        v[0][e] = a0;
      }
      const float h0 = h[0] - (cr * hw[0] - ci * hw[P - 1]);
      h[P - 1] = h[P - 1] - (cr * hw[P - 1] + ci * hw[0]);
      h[0] = h0;
    }
  }
}

// The row source of a pipe pass over a rebuilt column.
template <int P, int VEC, class LD>
struct RebuildRows {
  const float* av;
  const float* const* wp;
  const float* cf;
  int nw;
  float s;
  size_t plane;
  __device__ __forceinline__ void row(size_t base, int nv, int lane, bool hin,
                                      long hoff, float (&v)[P][4],
                                      float (&h)[P]) const {
    rebuild_row<P, VEC, LD>(av, wp, cf, nw, s, base, nv, plane, lane, hin,
                            hoff, v, h);
  }
};

// The operator's coefficients (load_coef's values) at a lane's four points
// of row r; every lane of the warp calls it (VEC = 4 shuffles).
template <int OP, int VEC>
__device__ __forceinline__ void coef_row(const Op2d& op, int r, int x0,
                                         int ny, int nx, size_t base, int nv,
                                         int lane, float (&k)[4][4]) {
  if (OP == OP_ISO) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      k[e][0] = stencil_diag(r, x0 + vcol<VEC>(lane, e), ny, nx, op.clean);
    return;
  }
  float wx[4], wy[4], wu[4];
  ldv<VEC>(op.wx + base, lane, nv, wx);
  ldv<VEC>(op.wy + base, lane, nv, wy);
  if (r > 0)
    ldv<VEC>(op.wy + base - nx, lane, nv, wu);
  else
    wu[0] = wu[1] = wu[2] = wu[3] = 0.0f;
  if (VEC == 4) {
    float left = __shfl_up_sync(0xffffffffu, wx[3], 1);
    if (lane == 0) left = x0 > 0 ? __ldg(op.wx + base - 1) : 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) k[e][1] = e == 0 ? left : wx[e - 1];
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = vcol<VEC>(lane, e);
      k[e][1] = x0 + c > 0 && c < nv ? __ldg(op.wx + base + c - 1) : 0.0f;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    k[e][0] = wx[e];
    k[e][2] = wy[e];
    k[e][3] = wu[e];
  }
}

// The left and right neighbours of a lane's four points of a ring row c
// (PX floats), with the halo columns h[0], h[1] at the tile's edges (read
// only by the lanes at the edges).
template <int VEC>
__device__ __forceinline__ void row_sides(const float* c, const float (&cv)[4],
                                          const float* h, int lane,
                                          float (&lf)[4], float (&rt)[4]) {
  if (VEC == 4) {
    const float l0 = __shfl_up_sync(0xffffffffu, cv[3], 1);
    const float r3 = __shfl_down_sync(0xffffffffu, cv[0], 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lf[e] = e > 0 ? cv[e - 1] : lane > 0 ? l0 : h[0];
      rt[e] = e < 3 ? cv[e + 1] : lane < 31 ? r3 : h[1];
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = vcol<VEC>(lane, e);
      lf[e] = x > 0 ? c[x - 1] : h[0];
      rt[e] = x < PX - 1 ? c[x + 1] : h[1];
    }
  }
}

// A lane's group sums for the dots: reduce over the group's lanes.
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The dots of tile row (base, nv) from W_{j+1} in wrow and, unless LAST,
// av_{j+1} in arow (shared rows of PX floats per plane): gram_i and d_i
// from one load of W_i. q, gl: the lane's dot group and its lane in it;
// g, d: the lane's sums of its group's columns.
template <int P, int MAXW, bool LAST, int VEC, class LD>
__device__ __forceinline__ void tile_dots(const float* const* wp, int nw,
                                          size_t plane, const float* wrow,
                                          const float* arow, size_t base,
                                          int nv, int q, int gl,
                                          float (&g)[4][2], float (&d)[4][2]) {
  constexpr int NG = MAXW / 4;        // dot groups per warp
  constexpr int L = 32 / NG;          // lanes per dot group
#pragma unroll
  for (int pc = 0; pc < NG; ++pc) {
    const int f = gl + L * pc;
    float wi[4][P][4], wv[P][4], a4[P][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {             // the group's loads first
      const int i = q + NG * c;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (i < nw)
          ldv<VEC, LD>(wp[i] + p * plane + base, f, nv, wi[c][p]);
        else
          wi[c][p][0] = wi[c][p][1] = wi[c][p][2] = wi[c][p][3] = 0.0f;
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      lds<VEC>(wrow + p * PX, f, wv[p]);
      if (!LAST) lds<VEC>(arow + p * PX, f, a4[p]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (q + NG * c < nw) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x[P], y[P], z[P];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            x[p] = wi[c][p][e];
            y[p] = wv[p][e];
            z[p] = LAST ? 0.0f : a4[p][e];
          }
          hdot<P>(x, y, g[c]);
          if (!LAST) hdot<P>(x, z, d[c]);
        }
      }
    }
  }
}

// dl += <W_{j+1}, av_{j+1}> over a lane's four points of one row (ring
// row c, av row a).
template <int P, int VEC>
__device__ __forceinline__ void dot_last(const float (*c)[PX],
                                         const float (*a)[PX], int lane,
                                         float (&dl)[2]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float cc[P], aa[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      cc[p] = c[p][vcol<VEC>(lane, e)];
      aa[p] = a[p][vcol<VEC>(lane, e)];
    }
    hdot<P>(cc, aa, dl);
  }
}

// The block's sums of one pipe pass, output-major: partial[o * gridDim.x +
// blockIdx.x] in the layout nsq | gram_i, i < nw | d_i, i <= nw (LAST: nsq
// and gram only). red: PWARP rows of RED_W.
template <int MAXW, bool LAST>
__device__ __forceinline__ void pipe_partials(
    float nsq, const float (&g)[4][2], const float (&d)[4][2],
    const float (&dl)[2], int nw, int lane, int w, int q, int gl,
    float (*red)[RED_W], float* __restrict__ partial) {
  constexpr int NG = MAXW / 4;
  constexpr int L = 32 / NG;
  nsq = warp_sum(nsq);
  if (lane == 0) red[w][0] = nsq;
  const int nd = 1 + 2 * nw;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int i = q + NG * c;
    float gs[2], ds[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      gs[h] = group_sum<L>(g[c][h]);
      ds[h] = LAST ? 0.0f : group_sum<L>(d[c][h]);
    }
    if (gl == 0 && i < nw) {
      red[w][1 + 2 * i] = gs[0];
      red[w][2 + 2 * i] = gs[1];
      if (!LAST) {
        red[w][nd + 2 * i] = ds[0];
        red[w][nd + 2 * i + 1] = ds[1];
      }
    }
  }
  int nout = nd;
  if (!LAST) {
    const float d0 = warp_sum(dl[0]), d1 = warp_sum(dl[1]);
    if (lane == 0) {
      red[w][nd + 2 * nw] = d0;
      red[w][nd + 2 * nw + 1] = d1;
    }
    nout += 2 * (nw + 1);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < nout; o += PT) {
    float v = red[0][o];
#pragma unroll
    for (int ww = 1; ww < PWARP; ++ww) v += red[ww][o];
    partial[(size_t)o * gridDim.x + blockIdx.x] = v;
  }
}

// One 2D pipe pass over every tile of the block (see the top of the file):
// the rows from src, W_{j+1} to wn_out, av_{j+1} = A(W_{j+1}) to av_out
// (unless LAST), and the block's sums to partial (pipe_partials; DOTS
// false: the norm and, unless LAST, d_{j+1} only). ring: RING rows (PWARP
// if LAST), hal: RING rows, avb: PWARP rows, red: PWARP rows of RED_W.
// lane, w: the thread's lane and warp; q, gl: its dot group (of 32 /
// (MAXW / 4) lanes) and its lane in the group.
template <int P, int MAXW, bool LAST, int OP, int VEC, class LD,
          bool DOTS = true, class SRC>
__device__ __forceinline__ void pipe2d_pass(
    const SRC& src, const float* const* wp, int nw, const Op2d& op,
    float* __restrict__ wn_out, float* __restrict__ av_out,
    float* __restrict__ partial, int ny, int nx, float ss, int steps,
    float (*ring)[P][PX], float (*hal)[P][2], float (*avb)[P][PX],
    float (*red)[RED_W], int lane, int w, int q, int gl) {
  const size_t plane = (size_t)ny * nx;
  const int ty = PWARP * steps - 2;
  const int ntx = (nx + PX - 1) / PX;
  const int ntiles = ntx * ((ny + ty - 1) / ty);
  float nsq = 0.0f;
  float g[4][2] = {}, d[4][2] = {};
  float dl[2] = {0.0f, 0.0f};        // d_{j+1} = <W_{j+1}, av_{j+1}>

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int y0 = (tile / ntx) * ty, x0 = (tile % ntx) * PX;
    const int nv = nx - x0;
    if constexpr (LAST) {
      for (int t = w; t < ty && y0 + t < ny; t += PWARP) {
        const size_t base = (size_t)(y0 + t) * nx + x0;
        float v[P][4], h[P];
        src.row(base, nv, lane, false, 0, v, h);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          stv<VEC>(wn_out + p * plane + base, lane, nv, v[p]);
          if (DOTS) sts<VEC>(ring[w][p], lane, v[p]);
#pragma unroll
          for (int e = 0; e < 4; ++e) nsq += v[p][e] * v[p][e];
        }
        if (DOTS) {
          __syncwarp();
          tile_dots<P, MAXW, true, VEC, LD>(wp, nw, plane, &ring[w][0][0],
                                            nullptr, base, nv, q, gl, g, d);
          __syncwarp();
        }
      }
    } else {
      for (int st = 0; st < steps; ++st) {
        const int k = PWARP * st + w;             // rebuilt row y0 - 1 + k
        if (k < ty + 2) {
          const int r = y0 - 1 + k;
          const int slot = k % RING;
          float v[P][4], h[P];
          const bool left = lane == 0, edge = left || lane == 31;
          if (r >= 0 && r < ny) {
            const size_t base = (size_t)r * nx + x0;
            const long hoff = left ? -1 : PX;
            const bool hin = edge && x0 + hoff >= 0 && x0 + hoff < nx;
            src.row(base, nv, lane, hin, hoff, v, h);
            if (k >= 1 && k <= ty) {
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
            sts<VEC>(ring[slot][p], lane, v[p]);
            if (edge) hal[slot][p][left ? 0 : 1] = h[p];
          }
        }
        __syncthreads();
        const int t = k - 2;                      // stencilled tile row
        if (t >= 0 && t < ty && y0 + t < ny) {
          const int r = y0 + t;
          const size_t base = (size_t)r * nx + x0;
          const int sc = (t + 1) % RING, su = t % RING, sd = (t + 2) % RING;
          float kf[4][4];
          coef_row<OP, VEC>(op, r, x0, ny, nx, base, nv, lane, kf);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            float cv[4], up[4], dn[4], lf[4], rt[4], a[4];
            lds<VEC>(ring[sc][p], lane, cv);
            lds<VEC>(ring[su][p], lane, up);
            lds<VEC>(ring[sd][p], lane, dn);
            row_sides<VEC>(ring[sc][p], cv, hal[sc][p], lane, lf, rt);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = vcol<VEC>(lane, e);
              a[e] = c < nv ? stencil<OP>(cv[e], up[e], dn[e], lf[e], rt[e], r,
                                          x0 + c, kf[e]) * ss
                            : 0.0f;
            }
            stv<VEC>(av_out + p * plane + base, lane, nv, a);
            sts<VEC>(avb[w][p], lane, a);
          }
          dot_last<P, VEC>(ring[sc], avb[w], lane, dl);
          if (DOTS) {
            __syncwarp();
            tile_dots<P, MAXW, false, VEC, LD>(wp, nw, plane, &ring[sc][0][0],
                                               &avb[w][0][0], base, nv, q, gl,
                                               g, d);
            __syncwarp();
          }
        }
      }
      __syncthreads();                            // the ring is reused
    }
  }
  pipe_partials<MAXW, LAST>(nsq, g, d, dl, nw, lane, w, q, gl, red, partial);
}

// ---------------------------------------------------------------- host side

// Blocks of `threads` threads of `kernel` that fit on the card at once.
template <class K>
int resident_blocks(K kernel, int threads) {
  int dev = 0, sms = 0, occ = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads,
                                                       0) != cudaSuccess)
    return 0;
  return occ * sms;
}

int num_sms() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
      return 0;
    return sms;
  }();
  return n;
}

int pipe_tiles(int ny, int nx, int steps) {
  const int ty = PWARP * steps - 2;
  return ((ny + ty - 1) / ty) * ((nx + PX - 1) / PX);
}

// Steps per 2D tile (ty = 8 steps - 2 rows) for a grid of `fit` resident
// blocks: the fewest steps the busiest block takes, ceil(tiles / fit)
// steps, and of those the tallest tiles (the fewest halo rows).
int pipe_steps(int ny, int nx, int fit) {
  int best = 8, cost = -1;
  for (int steps = 8; steps >= 2; --steps) {
    const int c = (pipe_tiles(ny, nx, steps) + fit - 1) / fit * steps;
    if (cost < 0 || c < cost) {
      best = steps;
      cost = c;
    }
  }
  return best;
}

// Most blocks of PT threads the card holds at once (2048 threads per SM):
// a bound on the partial sums per output of any pipe pass.
int pipe_max_blocks() { return 2048 / PT * num_sms(); }

bool aligned16(const void* p) {
  return p == nullptr || ((size_t)p & 15) == 0;
}

}  // namespace
