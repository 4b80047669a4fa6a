// Hand-written Hopper (sm_90a) kernel for one whole SS2 step of the 2D
// NLSE in one launch.
//
// Replaces the Pallas TPU kernel nlsolvers_tpu/ops/pallas/resident2d.py
// ss2_resident_step (K13): on a planar (2, ny, nx) float32 field u,
//   u1 = exp(i dt/2 rho(u)) u;  u2 = exp(i dt L) u1 by m-step Lanczos with
//   full reorthogonalization and a Taylor series for exp(i dt T) e1;
//   u3 = exp(i dt/2 rho(u2)) u2;  the no-flux ghost ring copy (optional).
// L is the 5-point no-flux Laplacian (reference or clean diagonal). The
// Taylor degree is chosen by the caller for a truncation error < 1e-8 from
// theta = |dt| 8 |scale| (the spectrum of dt L lies in [-theta, 0]), so no
// eigendecomposition is needed and no scalar ever leaves the card.
//
// What bounds it on an H100: bytes streamed from device memory. The basis
// (m x 2 x ny x nx float32, 84 MB at 1024^2, m = 10) does not fit in the
// 227 KB of shared memory of an SM, and at 1024^2 only partly in the 50 MB
// L2, so it lives in a device scratch the caller allocates once per problem
// and the step streams it. The float32 operations of the step (~1.1 GFLOP at
// 1024^2, m = 10) would take 0.016 ms; the columns streamed take longer.
//
// What the design does about it:
// * The Lanczos loop is the default path's pipelined recurrence with
//   deferred norms (ops/cuda/lanczos2d.py _lanczos_pipe): W_{j+1} = s_j av_j
//   - sum_i c_i W_i is rebuilt on the fly and stencilled into av_{j+1} in
//   the same pass, and the projections of the next iteration come from the
//   dots of this one, so an iteration streams j + 4 columns (the last m + 1)
//   and needs one grid sync. With the first pass (the kick, W_0 and av_0)
//   and the combine the step streams ~86 columns at m = 10 (~0.72 GB at
//   1024^2, 0.215 ms at 3.35 TB/s) in m grid syncs.
// * Each pass is one pipe pass of lz_tile.cuh, the tile walker of K2:
//   16-byte loads, a shared ring of rows with one barrier per step, the
//   stencil's side neighbours by shuffles, and the dots over lane groups,
//   gram and d from one load of each basis column. The first pass takes its
//   rows from the kicked field (KickRows): the kick is pointwise, so the
//   halo columns' kicks are recomputed where they are read.
// * One cooperative launch of the blocks that fit on the card at once; a
//   launch the card refuses returns its error, and nothing falls back.
// * After each grid sync every block reduces all partial sums in the same
//   order (lz_iter.cuh's reduce_all), so one warp in every block computes the
//   same scalars (s_j, c_i, alpha_j, beta_j) bit for bit, in
//   _lanczos_pipe's order, and the Taylor coefficients (lane i = row i of T).
//   The partial sums alternate between two buffers, so a block that runs
//   ahead never overwrites sums another block still reads.
// * The basis and the av columns are written and read inside the launch, so
//   every load of them goes to L2 (__ldcg), never through the read-only
//   cache.
// * The ghost ring is folded into the combine: the ring cell (r, x) takes
//   the kicked value of the interior cell (clamp(r), clamp(x)), which is
//   what the reference's row-then-column copy leaves there.
//
// Plain C interface for ctypes: every launcher returns a CUDA error code.

#include "lz_iter.cuh"
#include "lz_tile.cuh"

namespace {

// rho(u) of the NLSE kinds (models/nonlinearities.py).
struct Dens {
  int kind;       // 0 cubic, 1 cubic_quintic, 2 saturable
  float sigma1, sigma2, kappa;
};

__device__ __forceinline__ float density(const Dens& d, float mv, float re,
                                         float im) {
  const float a2 = re * re + im * im;
  if (d.kind == 0) return mv * a2;
  if (d.kind == 1) return mv * (d.sigma1 * a2 + d.sigma2 * a2 * a2);
  return mv * a2 / (1.0f + d.kappa * a2);
}

// (re, im) * exp(i half_dt rho), in place.
__device__ __forceinline__ void kick(float& re, float& im, float rho,
                                     float half_dt) {
  const float th = half_dt * rho;
  const float c = cosf(th), s = sinf(th);
  const float r2 = re * c - im * s;
  im = re * s + im * c;
  re = r2;
}

__device__ __forceinline__ float safe_inv(float nrm) {
  return nrm > 0.0f ? 1.0f / nrm : 0.0f;
}

__device__ __forceinline__ int clamp_ring(int v, int n) {
  return v == 0 ? 1 : (v == n - 1 ? n - 2 : v);
}

// Row source of the first pass: the first half kick of u (rho from the raw
// u, |u| being phase-invariant), at a lane's four points and, where hin, at
// the halo column.
template <int VEC>
struct KickRows {
  const float* u;
  const float* mf;
  Dens dens;
  float half_dt;
  size_t plane;
  __device__ __forceinline__ void row(size_t base, int nv, int lane, bool hin,
                                      long hoff, float (&v)[2][4],
                                      float (&h)[2]) const {
    float mv[4];
    ldv<VEC>(u + base, lane, nv, v[0]);
    ldv<VEC>(u + plane + base, lane, nv, v[1]);
    ldv<VEC>(mf + base, lane, nv, mv);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      kick(v[0][e], v[1][e], density(dens, mv[e], v[0][e], v[1][e]),
           half_dt);
    h[0] = h[1] = 0.0f;
    if (hin) {
      float re = __ldg(u + base + hoff), im = __ldg(u + plane + base + hoff);
      kick(re, im, density(dens, __ldg(mf + base + hoff), re, im), half_dt);
      h[0] = re;
      h[1] = im;
    }
  }
};

// basis: (m, 2, ny, nx) scratch (slot i holds W_i); avs: (2, 2, ny, nx),
// av_j in slot j % 2; part: two buffers of RED_W x gridDim.x partial sums.
// MAXW bounds the dot columns of a pass (nw = j + 1 <= m - 2; the last
// pass takes no dots). steps: the tile height of pipe_steps. Two blocks per
// SM (128 registers) for the 16-byte forms up to 8 columns; the 16- and
// 32-column ones (m > 10) would spill there, so they take one.
template <int MAXW, int VEC>
__global__ void __launch_bounds__(
    PT, VEC == 4 && MAXW < 16 ? 2 : 1) resident_kernel(
    const float* __restrict__ u, const float* __restrict__ mf,
    float* __restrict__ out, float* basis, float* avs, float* part, int m,
    Op2d op, int ny, int nx, float ss, double dt, float half_dt, int deg,
    Dens dens, int apply_bc, int steps) {
  __shared__ __align__(16) float ring[RING][2][PX];
  __shared__ float hal[RING][2][2];
  __shared__ __align__(16) float avb[PWARP][2][PX];
  __shared__ float red[PWARP][RED_W];
  __shared__ float rs[RED_W];
  __shared__ float cf[2 * MAXCOLS];
  __shared__ const float* wp[MAXCOLS];
  __shared__ float sv[MAXCOLS + 1], alpha[MAXCOLS], beta[MAXCOLS];
  __shared__ float gp[2 * MAXCOLS], gq[2 * MAXCOLS], dp[2 * MAXCOLS + 2];
  __shared__ float cre[MAXCOLS], cim[MAXCOLS];
  __shared__ float nsq0, beta0;
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t n = (size_t)ny * nx;
  const size_t col = 2 * n;
  if ((int)threadIdx.x < m) wp[threadIdx.x] = basis + threadIdx.x * col;
  __syncthreads();

  // W_0 = kick(u) into slot 0 and av_0 = A(W_0): ||W_0||^2 and d_0
  {
    const KickRows<VEC> src = {u, mf, dens, half_dt, n};
    pipe2d_pass<2, 4, false, OP_ISO, VEC, LdL2, false>(
        src, wp, 0, op, basis, avs, part, ny, nx, ss, steps, ring, hal, avb,
        red, lane, w, 0, lane);
  }
  grid.sync();
  reduce_all<PWARP>(part, 3, rs);
  if (threadIdx.x == 0) {
    nsq0 = rs[0];
    beta0 = sqrtf(rs[0]);
    sv[0] = safe_inv(beta0);
    dp[0] = rs[1];
    dp[1] = rs[2];
  }
  __syncthreads();

  // Lanczos, _lanczos_pipe's recurrence: W_{j+1} into slot j+1
  for (int j = 0; j < m - 1; ++j) {
    const int nw = j + 1;
    const bool last = j == m - 2;
    if (w == 0 && lane <= j) {
      // raw_i = <W_i, w_j> = s_j d_i - bs <W_i, W_{j-1}>, where the gram
      // terms are the pass before last's (i <= j-2), beta_{j-2}^2 or
      // ||W_0||^2 (i = j-1) and the conjugate of the last pass's gram_{j-1}
      // (i = j); c_i = s_i^2 raw_i + (i == j-1) bs
      const int i = lane;
      const float sj = sv[j];
      float rr, ri, bs = 0.0f;
      if (j == 0) {
        rr = sj * dp[0];
        ri = sj * dp[1];
      } else {
        bs = beta[j - 1] * sv[j - 1];
        float pr, pi = 0.0f;
        if (i <= j - 2) {
          pr = gq[2 * i];
          pi = gq[2 * i + 1];
        } else if (i == j - 1) {
          pr = j >= 2 ? beta[j - 2] * beta[j - 2] : nsq0;
        } else {
          pr = gp[2 * (j - 1)];
          pi = -gp[2 * (j - 1) + 1];
        }
        rr = sj * dp[2 * i] - bs * pr;
        ri = sj * dp[2 * i + 1] - bs * pi;
      }
      const float si = sv[i];
      const float qr = si * rr, qi = si * ri;
      if (i == j) alpha[j] = qr;
      float cr = si * qr;
      if (j > 0 && i == j - 1) cr += bs;
      cf[2 * i] = cr;
      cf[2 * i + 1] = si * qi;
    }
    __syncthreads();
    float* pj = part + (size_t)((j + 1) & 1) * RED_W * gridDim.x;
    float* wn = basis + (size_t)nw * col;
    float* avn = avs + (size_t)((j + 1) & 1) * col;
    const RebuildRows<2, VEC, LdL2> src = {avs + (size_t)(j & 1) * col, wp,
                                           cf, nw, sv[j], n};
#define RS_PASS(B, LAST, DOTS)                                             \
  pipe2d_pass<2, B, LAST, OP_ISO, VEC, LdL2, DOTS>(                         \
      src, wp, nw, op, wn, avn, pj, ny, nx, ss, steps, ring, hal, avb, red, \
      lane, w, lane / (128 / B), lane % (128 / B))
    if (last) {
      RS_PASS(4, true, false);                   // the norm only
    } else if (nw <= 4) {
      RS_PASS(4, false, true);
    } else {
      if constexpr (MAXW >= 8) {
        if (nw <= 8) {
          RS_PASS(8, false, true);
        } else {
          if constexpr (MAXW >= 16) {
            if (nw <= 16) {
              RS_PASS(16, false, true);
            } else {
              if constexpr (MAXW >= 32) RS_PASS(32, false, true);
            }
          }
        }
      }
    }
#undef RS_PASS
    grid.sync();
    reduce_all<PWARP>(pj, last ? 1 : 1 + 2 * nw + 2 * (nw + 1), rs);
    if (w == 0) {
      if (lane == 0) {
        beta[j] = sqrtf(rs[0]);
        sv[j + 1] = safe_inv(beta[j]);
      }
      if (!last && lane < nw) {                  // gram two passes back
        gq[2 * lane] = gp[2 * lane];
        gq[2 * lane + 1] = gp[2 * lane + 1];
        gp[2 * lane] = rs[1 + 2 * lane];
        gp[2 * lane + 1] = rs[2 + 2 * lane];
      }
      if (!last && lane <= nw) {
        dp[2 * lane] = rs[1 + 2 * nw + 2 * lane];
        dp[2 * lane + 1] = rs[2 + 2 * nw + 2 * lane];
      }
    }
    __syncthreads();
  }

  // exp(i dt T) e1 by its Taylor series: lane i holds row i of the
  // current term t_k = (i dt T / k) t_{k-1} and of the sum y; T(m-1, m-1)
  // stays 0 (the reference's loop never writes it)
  if (threadIdx.x < 32) {
    const int i = threadIdx.x;
    const float al = i < m - 1 ? alpha[i] : 0.0f;
    const float bu = i > 0 && i < m ? beta[i - 1] : 0.0f;
    const float bd = i < m - 1 ? beta[i] : 0.0f;
    float tre = i == 0 ? 1.0f : 0.0f, tim = 0.0f;
    float yre = tre, yim = tim;
    for (int k = 1; k <= deg; ++k) {
      const float ure = __shfl_up_sync(0xffffffffu, tre, 1);
      const float uim = __shfl_up_sync(0xffffffffu, tim, 1);
      const float dre = __shfl_down_sync(0xffffffffu, tre, 1);
      const float dim = __shfl_down_sync(0xffffffffu, tim, 1);
      float ar = al * tre, ai = al * tim;
      if (i > 0) {
        ar += bu * ure;
        ai += bu * uim;
      }
      if (i < m - 1) {
        ar += bd * dre;
        ai += bd * dim;
      }
      const float f = (float)(dt / k);      // i dt / k
      tre = -f * ai;
      tim = f * ar;
      yre = yre + tre;
      yim = yim + tim;
    }
    if (i < m) {
      cre[i] = beta0 * sv[i] * yre;
      cim[i] = beta0 * sv[i] * yim;
    }
  }
  __syncthreads();

  // combine, second half kick (rho from the combined field), ghost ring
  const size_t stride = (size_t)gridDim.x * PT;
  for (size_t e = (size_t)blockIdx.x * PT + threadIdx.x; e < n; e += stride) {
    const int r = (int)(e / nx);
    const int x = (int)(e - (size_t)r * nx);
    const size_t src = apply_bc ? (size_t)clamp_ring(r, ny) * nx
                                      + clamp_ring(x, nx)
                                : e;
    float re = 0.0f, im = 0.0f;
    for (int i = 0; i < m; ++i) {
      const float vr = __ldcg(basis + (size_t)i * col + src);
      const float vi = __ldcg(basis + (size_t)i * col + n + src);
      re = re + cre[i] * vr - cim[i] * vi;
      im = im + cre[i] * vi + cim[i] * vr;
    }
    kick(re, im, density(dens, __ldg(mf + src), re, im), half_dt);
    out[e] = re;
    out[n + e] = im;
  }
}

template <int MAXW, int VEC>
int launch_resident(const float* u, const float* mf, float* out,
                    float* basis, float* avs, float* part, int m, Op2d op,
                    int ny, int nx, float ss, double dt, float half_dt,
                    int deg, Dens dens, int apply_bc, cudaStream_t st) {
  auto kern = resident_kernel<MAXW, VEC>;
  static const int grid = resident_blocks(kern, PT);
  if (grid <= 0 || grid > pipe_max_blocks())
    return (int)cudaErrorCooperativeLaunchTooLarge;
  int steps = pipe_steps(ny, nx, grid);
  void* args[] = {&u, &mf, &out, &basis, &avs, &part, &m, &op, &ny, &nx,
                  &ss, &dt, &half_dt, &deg, &dens, &apply_bc, &steps};
  return coop_launch(kern, grid, args, st, PT);
}

template <int VEC>
int resident_bucket(int b, const float* u, const float* mf, float* out,
                    float* basis, float* avs, float* part, int m, Op2d op,
                    int ny, int nx, float ss, double dt, float half_dt,
                    int deg, Dens dens, int apply_bc, cudaStream_t st) {
#define RS_L(BB) launch_resident<BB, VEC>(u, mf, out, basis, avs, part, m, \
                                          op, ny, nx, ss, dt, half_dt, deg, \
                                          dens, apply_bc, st)
  if (b == 4) return RS_L(4);
  if (b == 8) return RS_L(8);
  if (b == 16) return RS_L(16);
  return RS_L(32);
#undef RS_L
}

}  // namespace

extern "C" {

int rs_max_cols() { return MAXCOLS; }

// Floats of the partial-sum scratch rs_step needs: two buffers of RED_W
// sums for each of the most blocks a launch uses.
long long rs_partial_floats() {
  return 2LL * RED_W * pipe_max_blocks();
}

const char* rs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One SS2 step. u, out: (2, ny, nx); mf: (ny, nx) m field; basis: (m, 2,
// ny, nx) and avs: (2, 2, ny, nx) scratch; partial: rs_partial_floats
// floats. kind: 0 cubic, 1 cubic_quintic, 2 saturable. deg: Taylor degree.
// Rows of nx % 4 == 0 columns with 16-byte aligned fields take the 16-byte
// form, any other grid the scalar one.
int rs_step(const float* u, const float* mf, float* out, float* basis,
            float* avs, float* partial, int m, int ny, int nx, float ss,
            int clean, double dt, float half_dt, int deg, int kind,
            float sigma1, float sigma2, float kappa, int apply_bc,
            cudaStream_t st) {
  if (m < 1 || m > MAXCOLS || ny < 3 || nx < 3 || deg < 1 || kind < 0
      || kind > 2)
    return (int)cudaErrorInvalidValue;
  const Op2d op = {nullptr, nullptr, clean};
  const Dens dens = {kind, sigma1, sigma2, kappa};
  const int b = bucket(m > 2 ? m - 2 : 1);
  const bool vec = nx % 4 == 0 && aligned16(u) && aligned16(mf)
                   && aligned16(basis) && aligned16(avs);
  if (vec)
    return resident_bucket<4>(b, u, mf, out, basis, avs, partial, m, op, ny,
                              nx, ss, dt, half_dt, deg, dens, apply_bc, st);
  return resident_bucket<1>(b, u, mf, out, basis, avs, partial, m, op, ny,
                            nx, ss, dt, half_dt, deg, dens, apply_bc, st);
}

}  // extern "C"
