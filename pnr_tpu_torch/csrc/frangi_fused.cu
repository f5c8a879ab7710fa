// Multi-scale 3-D Frangi vesselness for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_kernel` built by
// `_frangi3d_fused_impl` in pnr_tpu/ops/frangi_fused.py (one-read fused
// Frangi with VMEM plane rings, a bf16-split banded y matmul and a
// polynomial acos). This file computes WHAT that kernel computes, not how:
// per sigma, three launches of an edge-replicated 1-D Gaussian pass
// (x, y, z; f32 scratch in device memory), then one per-voxel launch that
// forms the six gamma-scaled second derivatives with jnp.gradient borders,
// solves the 3x3 eigenproblem in closed form with acosf, gates the
// vesselness, merges it into J and the uint8 directions where it is
// strictly greater than the earlier scales, and folds Jmin (first scale)
// and Jmax (final J) into a block reduction plus one float atomic each.
//
// What bounds it on the H100: device-memory traffic. Each sigma moves
// about 1 (u8) + 3x8 (three f32 read+write Gaussian passes) + ~4 (the
// per-voxel pass reads its stencil mostly from L1/L2) + 7 (J + 3 u8
// directions, read-modify-write) bytes per voxel, so roughly 35 B/voxel
// per sigma, ~105 B/voxel at three sigmas. At 3.35 TB/s that is ~1.6 ms
// for a 52.4-Mvox stack at the roofline; the Gaussian passes read
// uncoalesced along z/y only through the L2. The design keeps every pass
// a plain streaming kernel (one thread per voxel, coalesced along x) so
// it is right first; the one-read fusion with shared-memory plane rings
// is later work.
//
// Numerics follow pnr_tpu/ops/frangi.py: IEEE expf/sqrtf/acosf (no fast
// math), half-to-even quantisation (rintf), NaN -> 0, strict '>' merge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-20f;
constexpr float kTwoPiOver3 = 2.0943951023931953f;

__device__ __forceinline__ unsigned int float_to_ordered(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ordered_to_float(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Correlate along `axis` with `ntaps` taps, edge-replicated borders.
template <typename T>
__global__ void gauss1d_kernel(const T* __restrict__ in, float* __restrict__ out,
                               int Z, int Y, int X, int axis,
                               const float* __restrict__ taps, int ntaps) {
  const long long n = (long long)Z * Y * X;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % X);
  const long long r = i / X;
  const int y = (int)(r % Y);
  const int z = (int)(r / Y);
  const int len = axis == 0 ? Z : (axis == 1 ? Y : X);
  const int pos = axis == 0 ? z : (axis == 1 ? y : x);
  const long long stride = axis == 0 ? (long long)Y * X : (axis == 1 ? (long long)X : 1LL);
  const long long base = i - (long long)pos * stride;
  const int half = ntaps / 2;
  float acc = 0.0f;
  for (int t = 0; t < ntaps; ++t) {
    const int q = min(max(pos + t - half, 0), len - 1);
    acc += __ldg(taps + t) * (float)__ldg(in + base + (long long)q * stride);
  }
  out[i] = acc;
}

struct Grid3 {
  const float* f;
  int Z, Y, X;
  __device__ __forceinline__ float at(int z, int y, int x) const {
    return __ldg(f + ((long long)z * Y + y) * X + x);
  }
  __device__ __forceinline__ int dim(int a) const { return a == 0 ? Z : (a == 1 ? Y : X); }
};

__device__ __forceinline__ int coord(int z, int y, int x, int a) {
  return a == 0 ? z : (a == 1 ? y : x);
}

__device__ __forceinline__ void shift(int& z, int& y, int& x, int a, int v) {
  if (a == 0) z = v; else if (a == 1) y = v; else x = v;
}

// jnp.gradient along axis a: central interior, one-sided borders.
__device__ float grad1(const Grid3& g, int z, int y, int x, int a) {
  const int n = g.dim(a), p = coord(z, y, x, a);
  int zl = z, yl = y, xl = x, zh = z, yh = y, xh = x;
  shift(zl, yl, xl, a, p == 0 ? 0 : p - 1);
  shift(zh, yh, xh, a, p == n - 1 ? n - 1 : p + 1);
  const float d = g.at(zh, yh, xh) - g.at(zl, yl, xl);
  return (p == 0 || p == n - 1) ? d : d * 0.5f;
}

// jnp.gradient along axis b of (jnp.gradient along axis a).
__device__ float grad2(const Grid3& g, int z, int y, int x, int a, int b) {
  const int n = g.dim(b), p = coord(z, y, x, b);
  int zl = z, yl = y, xl = x, zh = z, yh = y, xh = x;
  shift(zl, yl, xl, b, p == 0 ? 0 : p - 1);
  shift(zh, yh, xh, b, p == n - 1 ? n - 1 : p + 1);
  const float d = grad1(g, zh, yh, xh, a) - grad1(g, zl, yl, xl, a);
  return (p == 0 || p == n - 1) ? d : d * 0.5f;
}

__device__ __forceinline__ unsigned char quantize_dir(float v) {
  const float q = rintf(((v + 1.0f) / 2.0f) * 255.0f);
  return (unsigned char)fminf(fmaxf(q, 0.0f), 255.0f);
}

// Closed-form |lambda|-sorted eigensolve (pnr_tpu/ops/eig3.py).
__device__ void eig3_vessel(float a11, float a22, float a33, float a12, float a13, float a23,
                            float& lam1, float& lam2, float& lam3,
                            float& vx, float& vy, float& vz) {
  const float p1 = a12 * a12 + a13 * a13 + a23 * a23;
  const float q = (a11 + a22 + a33) / 3.0f;
  const float b11 = a11 - q, b22 = a22 - q, b33 = a33 - q;
  const float p2 = b11 * b11 + b22 * b22 + b33 * b33 + 2.0f * p1;
  const float p = sqrtf(fmaxf(p2 / 6.0f, 0.0f));
  const float ps = fmaxf(p, kEps);
  const float c11 = b11 / ps, c22 = b22 / ps, c33 = b33 / ps;
  const float c12 = a12 / ps, c13 = a13 / ps, c23 = a23 / ps;
  const float detb = c11 * (c22 * c33 - c23 * c23) - c12 * (c12 * c33 - c23 * c13) +
                     c13 * (c12 * c23 - c22 * c13);
  const float r = fminf(fmaxf(detb / 2.0f, -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  float e_hi = q + 2.0f * p * cosf(phi);
  float e_lo = q + 2.0f * p * cosf(phi + kTwoPiOver3);
  float e_mid = 3.0f * q - e_hi - e_lo;
  if (p2 <= kEps) e_lo = e_mid = e_hi = q;

  const float ab_lo = fabsf(e_lo), ab_mid = fabsf(e_mid), ab_hi = fabsf(e_hi);
  const bool s1 = ab_lo <= ab_mid;
  const float p0 = s1 ? e_lo : e_mid, p1_ = s1 ? e_mid : e_lo;
  const float q0 = s1 ? ab_lo : ab_mid, q1 = s1 ? ab_mid : ab_lo;
  const bool s2 = ab_hi < q0, s3 = ab_hi < q1;
  lam1 = s2 ? e_hi : p0;
  lam2 = s2 ? p0 : (s3 ? e_hi : p1_);
  lam3 = s2 ? p1_ : (s3 ? p1_ : e_hi);

  // eigenvector of lam1: the largest cross product of rows of A - lam1 I
  const float r1x = a11 - lam1, r1y = a12, r1z = a13;
  const float r2x = a12, r2y = a22 - lam1, r2z = a23;
  const float r3x = a13, r3y = a23, r3z = a33 - lam1;
  const float c1x = r1y * r2z - r1z * r2y, c1y = r1z * r2x - r1x * r2z, c1z = r1x * r2y - r1y * r2x;
  const float c2x = r1y * r3z - r1z * r3y, c2y = r1z * r3x - r1x * r3z, c2z = r1x * r3y - r1y * r3x;
  const float c3x = r2y * r3z - r2z * r3y, c3y = r2z * r3x - r2x * r3z, c3z = r2x * r3y - r2y * r3x;
  const float n1 = c1x * c1x + c1y * c1y + c1z * c1z;
  const float n2 = c2x * c2x + c2y * c2y + c2z * c2z;
  const float n3 = c3x * c3x + c3y * c3y + c3z * c3z;
  const bool use2 = n2 > n1;
  float ux = use2 ? c2x : c1x, uy = use2 ? c2y : c1y, uz = use2 ? c2z : c1z;
  float nb = use2 ? n2 : n1;
  const bool use3 = n3 > nb;
  ux = use3 ? c3x : ux;
  uy = use3 ? c3y : uy;
  uz = use3 ? c3z : uz;
  nb = use3 ? n3 : nb;
  if (nb <= kEps) {
    vx = 1.0f; vy = 0.0f; vz = 0.0f;
  } else {
    const float inv = 1.0f / sqrtf(nb);
    vx = ux * inv; vy = uy * inv; vz = uz * inv;
  }
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One sigma: Hessian of the smoothed volume F, eigensolve, vesselness,
// merge into (J, vx, vy, vz); Jmin over the first scale, Jmax over the
// final J, as ordered-int atomics in stats[0] / stats[1].
__global__ void frangi_scale_kernel(const float* __restrict__ F, int Z, int Y, int X,
                                    float s2, float a2, float b2, float c2, int blackwhite,
                                    int first, int last, float* __restrict__ J,
                                    unsigned char* __restrict__ qx, unsigned char* __restrict__ qy,
                                    unsigned char* __restrict__ qz, unsigned int* __restrict__ stats) {
  __shared__ float smin[kThreads / 32];
  __shared__ float smax[kThreads / 32];
  const long long n = (long long)Z * Y * X;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float vmin = __int_as_float(0x7f800000);   // +inf
  float vmax = __int_as_float(0xff800000);   // -inf
  if (i < n) {
    const Grid3 g{F, Z, Y, X};
    const int x = (int)(i % X);
    const long long r = i / X;
    const int y = (int)(r % Y);
    const int z = (int)(r / Y);
    const float dzz = grad2(g, z, y, x, 0, 0) * s2;
    const float dyy = grad2(g, z, y, x, 1, 1) * s2;
    const float dyz = grad2(g, z, y, x, 1, 0) * s2;
    const float dxx = grad2(g, z, y, x, 2, 2) * s2;
    const float dxy = grad2(g, z, y, x, 2, 1) * s2;
    const float dxz = grad2(g, z, y, x, 2, 0) * s2;
    float l1, l2, l3, ex, ey, ez;
    eig3_vessel(dxx, dyy, dzz, dxy, dxz, dyz, l1, l2, l3, ex, ey, ez);
    const float aa1 = fabsf(l1), aa2 = fabsf(l2), aa3 = fabsf(l3);
    const float ra = aa2 / aa3;
    const float rb = aa1 / sqrtf(aa2 * aa3);
    const float s = sqrtf(aa1 * aa1 + aa2 * aa2 + aa3 * aa3);
    float v = (1.0f - expf(-(ra * ra) / a2)) * expf(-(rb * rb) / b2) *
              (1.0f - expf(-(s * s) / c2));
    const bool gate = blackwhite ? (l2 < 0.0f || l3 < 0.0f) : (l2 > 0.0f || l3 > 0.0f);
    if (gate) v = 0.0f;
    if (v != v) v = 0.0f;
    float jv;
    if (first || v > J[i]) {
      J[i] = v;
      qx[i] = quantize_dir(ex);
      qy[i] = quantize_dir(ey);
      qz[i] = quantize_dir(ez);
      jv = v;
    } else {
      jv = J[i];
    }
    if (first) vmin = v;
    if (last) vmax = jv;
  }
  if (!first && !last) return;
  vmin = warp_min(vmin);
  vmax = warp_max(vmax);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    smin[warp] = vmin;
    smax[warp] = vmax;
  }
  __syncthreads();
  if (warp == 0) {
    vmin = lane < kThreads / 32 ? smin[lane] : __int_as_float(0x7f800000);
    vmax = lane < kThreads / 32 ? smax[lane] : __int_as_float(0xff800000);
    vmin = warp_min(vmin);
    vmax = warp_max(vmax);
    if (lane == 0) {
      if (first) atomicMin(stats + 0, float_to_ordered(vmin));
      if (last) atomicMax(stats + 1, float_to_ordered(vmax));
    }
  }
}

__global__ void decode_stats_kernel(const unsigned int* __restrict__ stats, float* __restrict__ out) {
  if (threadIdx.x == 0) {
    out[0] = ordered_to_float(stats[0]);
    out[1] = ordered_to_float(stats[1]);
  }
}

inline unsigned int blocks_for(long long n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// One edge-replicated 1-D Gaussian pass along `axis` (0=z, 1=y, 2=x).
// `in_is_u8` selects a uint8 or float32 input; the output is float32.
int pnr_gauss1d(const void* in, int in_is_u8, void* out, int Z, int Y, int X, int axis,
                const void* taps, int ntaps, void* stream) {
  const long long n = (long long)Z * Y * X;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_is_u8) {
    gauss1d_kernel<unsigned char><<<blocks_for(n), kThreads, 0, s>>>(
        (const unsigned char*)in, (float*)out, Z, Y, X, axis, (const float*)taps, ntaps);
  } else {
    gauss1d_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        (const float*)in, (float*)out, Z, Y, X, axis, (const float*)taps, ntaps);
  }
  return (int)cudaGetLastError();
}

// One sigma's Hessian/eigen/vesselness/merge pass over the smoothed F.
// `stats` is uint32[2] (ordered-int min, max), initialised by the caller
// to {0xffffffff, 0}; after the last scale `minmax` (float32[2]) receives
// (Jmin, Jmax).
int pnr_frangi_scale(const void* F, int Z, int Y, int X, float s2, float a2, float b2, float c2,
                     int blackwhite, int first, int last, void* J, void* qx, void* qy, void* qz,
                     void* stats, void* minmax, void* stream) {
  const long long n = (long long)Z * Y * X;
  cudaStream_t s = (cudaStream_t)stream;
  frangi_scale_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      (const float*)F, Z, Y, X, s2, a2, b2, c2, blackwhite, first, last, (float*)J,
      (unsigned char*)qx, (unsigned char*)qy, (unsigned char*)qz, (unsigned int*)stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !last) return (int)err;
  decode_stats_kernel<<<1, 32, 0, s>>>((const unsigned int*)stats, (float*)minmax);
  return (int)cudaGetLastError();
}

}  // extern "C"
