// Hand-written Hopper (sm_90a) kernel for one whole SS2 step of the 2D
// NLSE in one launch.
//
// Replaces the Pallas TPU kernel nlsolvers_tpu/ops/pallas/resident2d.py
// ss2_resident_step (K13): on a planar (2, ny, nx) float32 field u,
//   u1 = exp(i dt/2 rho(u)) u;  u2 = exp(i dt L) u1 by m-step Lanczos with
//   full reorthogonalization (classical Gram-Schmidt) and a Taylor series
//   for exp(i dt T) e1;  u3 = exp(i dt/2 rho(u2)) u2;  the no-flux ghost
//   ring copy (optional).
// L is the 5-point no-flux Laplacian (reference or clean diagonal). The
// Taylor degree is chosen by the caller for a truncation error < 1e-8 from
// theta = |dt| 8 |scale| (the spectrum of dt L lies in [-theta, 0]), so no
// eigendecomposition is needed and no scalar ever leaves the card.
//
// What bounds it on an H100: bytes streamed from device memory. On the TPU
// the whole basis (m x 2 x ny x nx float32, 84 MB at 1024^2, m = 10) stayed
// in VMEM; the H100 has 227 KB of shared memory per SM and 50 MB of L2, so
// here the basis lives in a device scratch the caller allocates once per
// problem, and the step streams it: the m-1 iterations read and write
// about 2j+5 columns each (117 columns of 8.4 MB at 1024^2, m = 10), the
// kicks and the combine m+4 more: ~1.1 GB per step, a byte bound of ~0.33
// ms. The streaming path (K1-K3) moves 0.70 GB in 11 launches plus ~300
// small ones and waits for the host's eigh once per step; this kernel is
// ONE launch with no host sync.
//
// What the design does about it:
// * One cooperative launch: the grid is as many blocks as fit on the card
//   at once (at most two per SM), they walk the cells in a fixed
//   grid-stride order, and the 2m-1 phases are separated by grid syncs.
//   A launch the card refuses returns its error; nothing falls back.
// * The phase bodies are lz_iter.cuh's, shared with the fused iteration
//   K5, and the stencil is lz_stencil.cuh's, shared with K1/K2.
// * Every block reduces all partial sums in the same order (reduce_all), so
//   each block holds the same alpha, beta and s_i bit for bit and computes
//   the Taylor coefficients itself (one warp, lane i = row i of T).
// * The basis is written and read inside the launch, so every load of it
//   goes to L2 (__ldcg), never through the read-only cache.
// * The ghost ring is folded into the combine: the ring cell (r, x) takes
//   the kicked value of the interior cell (clamp(r), clamp(x)), which is
//   what the reference's row-then-column copy leaves there.
//
// Plain C interface for ctypes: every launcher returns a CUDA error code.

#include "lz_iter.cuh"

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

// basis: (m, 2, ny, nx) scratch; part_a / part_b: partial-sum rows.
// MAXW bounds the columns of one iteration (j + 1 <= m - 1).
template <int MAXW>
__global__ void __launch_bounds__(CT) resident_kernel(
    const float* __restrict__ u, const float* __restrict__ mf,
    float* __restrict__ out, float* basis, float* part_a, float* part_b,
    int m, OpArgs a, double dt, float half_dt, int deg, Dens dens,
    int apply_bc) {
  __shared__ float red[CWARP][RED_W];
  __shared__ float rs[2 * MAXCOLS];
  __shared__ float sv[MAXCOLS + 1], alpha[MAXCOLS], beta[MAXCOLS];
  __shared__ float cre[MAXCOLS], cim[MAXCOLS];
  __shared__ float beta0;
  cg::grid_group grid = cg::this_grid();
  const int ny = a.ny, nx = a.nx;
  const size_t n = (size_t)ny * nx;
  const size_t col = 2 * n;
  const size_t stride = (size_t)gridDim.x * CT;
  const size_t first = (size_t)blockIdx.x * CT + threadIdx.x;

  // first half kick; rho from the raw u (|u| is phase-invariant)
  float nsq = 0.0f;
  for (size_t e = first; e < n; e += stride) {
    float re = __ldg(u + e), im = __ldg(u + n + e);
    kick(re, im, density(dens, __ldg(mf + e), re, im), half_dt);
    basis[e] = re;
    basis[n + e] = im;
    nsq += re * re + im * im;
  }
  cput(red, 0, nsq);
  cwrite(red, 1, part_b);
  grid.sync();
  reduce_all(part_b, 1, rs);
  if (threadIdx.x == 0) {
    beta0 = sqrtf(rs[0]);
    sv[0] = safe_inv(beta0);
  }
  __syncthreads();

  // Lanczos: W_{j+1} is built in place in slot j+1
  const ColSlab W = {basis, col};
  for (int j = 0; j < m - 1; ++j) {
    const float s = sv[j];
    const float bs = j > 0 ? beta[j - 1] * sv[j - 1] : 0.0f;
    float* wn = basis + (size_t)(j + 1) * col;
    phase_w<2, MAXW, OPK_ISO2D, LdL2>(s, bs, W, j, a, wn, red, part_a);
    grid.sync();
    reduce_all(part_a, 2 * (j + 1), rs);
    if (threadIdx.x == 0) alpha[j] = s * rs[2 * j];
    phase_sub<2, MAXW, LdL2>(W, j, sv, rs, n, wn, wn, red, part_b);
    grid.sync();
    reduce_all(part_b, 1, rs);
    if (threadIdx.x == 0) {
      beta[j] = sqrtf(rs[0]);
      sv[j + 1] = safe_inv(beta[j]);
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
  for (size_t e = first; e < n; e += stride) {
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

template <int MAXW>
int resident_grid() {
  static const int g = coop_blocks(resident_kernel<MAXW>);
  return g;
}

template <int MAXW>
int launch_resident(const float* u, const float* mf, float* out,
                    float* basis, float* part_a, float* part_b, int m,
                    OpArgs a, double dt, float half_dt, int deg, Dens dens,
                    int apply_bc, cudaStream_t st) {
  void* args[] = {&u, &mf, &out, &basis, &part_a, &part_b, &m, &a, &dt,
                  &half_dt, &deg, &dens, &apply_bc};
  return coop_launch(resident_kernel<MAXW>, resident_grid<MAXW>(), args, st);
}

}  // namespace

extern "C" {

int rs_max_cols() { return MAXCOLS; }

// Rows of the partial-sum scratch: rs_step needs (2 MAXCOLS + 1) *
// rs_max_blocks floats.
int rs_max_blocks() { return coop_max_blocks(); }

const char* rs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One SS2 step. u, out: (2, ny, nx); mf: (ny, nx) m field; basis: (m, 2,
// ny, nx) scratch; partial: (2 MAXCOLS + 1) * rs_max_blocks floats.
// kind: 0 cubic, 1 cubic_quintic, 2 saturable. deg: Taylor degree.
int rs_step(const float* u, const float* mf, float* out, float* basis,
            float* partial, int m, int ny, int nx, float ss, int clean,
            double dt, float half_dt, int deg, int kind, float sigma1,
            float sigma2, float kappa, int apply_bc, cudaStream_t st) {
  if (m < 1 || m > MAXCOLS || ny < 3 || nx < 3 || deg < 1 || kind < 0
      || kind > 2)
    return (int)cudaErrorInvalidValue;
  const OpArgs a = {Op2d{nullptr, nullptr, clean}, 1, ny, nx, ss};
  const Dens dens = {kind, sigma1, sigma2, kappa};
  float* part_b = partial + (size_t)2 * MAXCOLS * coop_max_blocks();
  const int b = bucket(m > 1 ? m - 1 : 1);
#define RS_L(BB) launch_resident<BB>(u, mf, out, basis, partial, part_b, m, \
                                     a, dt, half_dt, deg, dens, apply_bc, st)
  if (b == 4) return RS_L(4);
  if (b == 8) return RS_L(8);
  if (b == 16) return RS_L(16);
  return RS_L(32);
#undef RS_L
}

}  // extern "C"
