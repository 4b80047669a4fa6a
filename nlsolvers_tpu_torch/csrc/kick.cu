// Hand-written Hopper (sm_90a) kernel for the SS2 step's half phase kick,
// with the no-flux ghost copy folded in.
//
// Replaces, on the SS2 step's path:
//   kick_bc <- bc3d.py _bc_call (K14), the 6-face ghost copy of a planar 3D
//              state (and ops/boundaries.py neumann_no_velocity_2d, the 2D
//              one that XLA fuses), composed with the phase kick
//              up * exp(i theta rho(|up|^2)) that closes every SS2 step
//              (models/nlse.py phase_kick_planar, fused by XLA): on the whole
//              grid or on one shard's block at global offsets, 2D or 3D. With
//              the ghost copy off it is the step's opening kick.
//
// What it computes: out = ghost(kick(u)) on a planar (2, R, nx) float32
// block, R = nz * ny (nz = 1 in 2D), out of place. The kick is pointwise,
// so ghost(kick(u))[i] = kick(u[clamp(i)]): every output cell (z, y, x)
// takes the kicked input cell (cz, cy, cx), where clamp maps 0 to 1 on a
// block that holds the grid's low face of that axis and n-1 to n-2 on one
// that holds the high face, and is the identity elsewhere. With the
// reference's update order (x faces on interior y and z, then y faces on
// interior z, then z faces; in 2D rows on interior columns, then columns)
// that is the same value, corners included (bc3d_kernel in lanczos3d.cu
// relies on the same rule). rho is the NLSE density of the kind KIND, with
// m read at the source cell. The arithmetic is PyTorch's plain version's
// op for op: products, sums and the quotient are rounded one at a time
// (__fmul_rn and friends, no FMA contraction) and sin/cos are the precise
// sincosf, not the fast-math intrinsics.
//
// What bounds it on an H100: bytes. It reads u (8 bytes a cell) and m (4)
// and writes out (8): 20 bytes a cell, 21 MB at 1024^2, 42 MB at 128^3,
// against ~45 flops a cell. The bound counts a face row's source row once;
// the kernel reads it twice, but its neighbours read it at about the same
// time, so the second read comes from L2.
//
// What the design does about it:
// * One streaming pass over a fixed grid (one wave of resident blocks, a
//   grid-stride loop). A warp takes one item at a time: 32 lanes x VEC
//   consecutive x of one output row. The row's source row (cz, cy) is one
//   clamp per item, uniform over the warp.
// * VEC 4: 16-byte loads of re, im and m and 16-byte stores, where nx % 4
//   == 0 and every pointer is 16-byte aligned. The x faces take their value
//   from the same thread's registers (x = 0 from x = 1, x = nx-1 from
//   x = nx-2, both in the thread's four), so no shuffle and no shared
//   memory. VEC 1, the scalar form, serves every other grid: each lane
//   reads its own clamped source cell.
// * Out of place: the input stays as it was (the two-step integrators keep
//   it as u_prev), and the clamped reads race with no write.
// * A batch of B states (B, 2, R, nx) takes one launch: lane b is
//   blockIdx.y, with the unbatched grid and walk, its state and output
//   2 R nx floats past lane 0's and its m field R nx floats past. The
//   faces are the same for every lane.
//
// Plain C interface for ctypes: the launcher returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int KT = 256;           // threads per block
constexpr int KW = KT / 32;       // warps per block

struct Dens {
  float theta, sigma1, sigma2, kappa;
};

// Which faces of the grid the block holds (0 or 1 each); all 0 without the
// ghost copy.
struct Faces {
  int zl, zh, yl, yh, xl, xh;
};

__device__ __forceinline__ int clamp_face(int v, int n, int lo, int hi) {
  return lo && v == 0 ? 1 : (hi && v == n - 1 ? n - 2 : v);
}

// rho(a), a = |u|^2, of models/nonlinearities.py, op for op.
template <int KIND>
__device__ __forceinline__ float density(float mv, float a, const Dens& d) {
  if (KIND == 0) return __fmul_rn(mv, a);
  if (KIND == 1)
    return __fmul_rn(mv, __fadd_rn(__fmul_rn(d.sigma1, a),
                                   __fmul_rn(__fmul_rn(d.sigma2, a), a)));
  return __fdiv_rn(__fmul_rn(mv, a), __fadd_rn(1.0f, __fmul_rn(d.kappa, a)));
}

// (re, im) * exp(i theta rho), in place: phase_kick_planar's arithmetic.
template <int KIND>
__device__ __forceinline__ void kick(float& re, float& im, float mv,
                                     const Dens& d) {
  const float a = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
  const float th = __fmul_rn(d.theta, density<KIND>(mv, a, d));
  float s, c;
  sincosf(th, &s, &c);
  const float r2 = __fsub_rn(__fmul_rn(re, c), __fmul_rn(im, s));
  im = __fadd_rn(__fmul_rn(re, s), __fmul_rn(im, c));
  re = r2;
}

template <int KIND, int VEC>
__global__ void __launch_bounds__(KT) kick_bc_kernel(
    const float* __restrict__ u, const float* __restrict__ mf,
    float* __restrict__ out, int nz, int ny, int nx, Faces f, Dens d) {
  const size_t plane = (size_t)nz * ny * nx;
  u += blockIdx.y * 2 * plane;
  out += blockIdx.y * 2 * plane;
  mf += blockIdx.y * plane;
  const int lane = threadIdx.x & 31;
  const int per_row = (nx + 32 * VEC - 1) / (32 * VEC);   // items per row
  const long long items = (long long)nz * ny * per_row;
  const long long stride = (long long)gridDim.x * KW;
  for (long long it = (long long)blockIdx.x * KW + (threadIdx.x >> 5);
       it < items; it += stride) {
    const int r = (int)(it / per_row);
    const int c = (int)(it - (long long)r * per_row);
    const int z = r / ny, y = r - z * ny;
    const size_t dst = (size_t)r * nx;
    const size_t src = ((size_t)clamp_face(z, nz, f.zl, f.zh) * ny
                        + clamp_face(y, ny, f.yl, f.yh)) * nx;
    if (VEC == 4) {
      const int q = c * 32 + lane;               // this lane's quad
      if (q * 4 >= nx) continue;
      float4 a = __ldg(reinterpret_cast<const float4*>(u + src) + q);
      float4 b = __ldg(reinterpret_cast<const float4*>(u + plane + src) + q);
      const float4 m = __ldg(reinterpret_cast<const float4*>(mf + src) + q);
      kick<KIND>(a.x, b.x, m.x, d);
      kick<KIND>(a.y, b.y, m.y, d);
      kick<KIND>(a.z, b.z, m.z, d);
      kick<KIND>(a.w, b.w, m.w, d);
      if (f.xl && q == 0) {
        a.x = a.y;
        b.x = b.y;
      }
      if (f.xh && q == nx / 4 - 1) {
        a.w = a.z;
        b.w = b.z;
      }
      reinterpret_cast<float4*>(out + dst)[q] = a;
      reinterpret_cast<float4*>(out + plane + dst)[q] = b;
    } else {
      const int x = c * 32 + lane;
      if (x >= nx) continue;
      const size_t s = src + clamp_face(x, nx, f.xl, f.xh);
      float re = __ldg(u + s), im = __ldg(u + plane + s);
      kick<KIND>(re, im, __ldg(mf + s), d);
      out[dst + x] = re;
      out[plane + dst + x] = im;
    }
  }
}

template <int KIND, int VEC>
int launch(int B, const float* u, const float* mf, float* out, int nz,
           int ny, int nx, Faces f, Dens d, cudaStream_t st) {
  auto kern = kick_bc_kernel<KIND, VEC>;
  static int resident = 0;      // blocks of this instantiation per SM
  static int sms = 0;
  if (resident == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kern, KT,
                                                        0);
    if (e != cudaSuccess) return (int)e;
    if (resident <= 0 || sms <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  const long long per_row = (nx + 32 * VEC - 1) / (32 * VEC);
  const long long items = (long long)nz * ny * per_row;
  const long long want = (items + KW - 1) / KW;
  const long long cap = (long long)resident * sms;
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  kern<<<dim3(grid, B), KT, 0, st>>>(u, mf, out, nz, ny, nx, f, d);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_kind(int vec, int B, const float* u, const float* mf, float* out,
                int nz, int ny, int nx, Faces f, Dens d, cudaStream_t st) {
  return vec == 4 ? launch<KIND, 4>(B, u, mf, out, nz, ny, nx, f, d, st)
                  : launch<KIND, 1>(B, u, mf, out, nz, ny, nx, f, d, st);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

}  // namespace

extern "C" {

const char* kick_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// kick_bc: out = ghost(u * exp(i theta rho(|u|^2))) on each of B planar
// (2, nz*ny, nx) blocks u (B, 2, nz*ny, nx), out of place (out must not
// overlap u). kind: 0 cubic, 1 cubic_quintic, 2 saturable; m holds the
// (nz*ny, nx) m field of each lane, (B, nz*ny, nx). zl..xh say which faces
// of the grid the block holds
// (all 0: the kick alone); an axis with a face needs at least 2 cells. vec
// 4 takes the 16-byte form (nx % 4 == 0, every pointer 16-byte aligned),
// vec 1 the scalar one.
int kick_bc(int kind, int vec, int B, const float* u, const float* m,
            float* out, int nz, int ny, int nx, int zl, int zh, int yl,
            int yh, int xl, int xh, float theta, float sigma1, float sigma2,
            float kappa, cudaStream_t st) {
  const Faces f{zl != 0, zh != 0, yl != 0, yh != 0, xl != 0, xh != 0};
  if (kind < 0 || kind > 2 || (vec != 1 && vec != 4) || B < 1 || B > 65535
      || nz < 1 || ny < 1
      || nx < 1 || (long long)nz * ny > 0x7fffffffll
      || ((f.zl || f.zh) && nz < 2) || ((f.yl || f.yh) && ny < 2)
      || ((f.xl || f.xh) && nx < 2))
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (nx % 4 != 0 || !aligned16(u) || !aligned16(m)
                   || !aligned16(out)))
    return (int)cudaErrorInvalidValue;
  const Dens d{theta, sigma1, sigma2, kappa};
  if (kind == 0)
    return launch_kind<0>(vec, B, u, m, out, nz, ny, nx, f, d, st);
  if (kind == 1)
    return launch_kind<1>(vec, B, u, m, out, nz, ny, nx, f, d, st);
  return launch_kind<2>(vec, B, u, m, out, nz, ny, nx, f, d, st);
}

}  // extern "C"
