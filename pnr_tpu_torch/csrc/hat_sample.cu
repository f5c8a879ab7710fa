// Tube-map hat sampling for Hopper (sm_90a): K5 (patch) and K6 (field).
//
// Replaces: the Pallas TPU kernels `_kernel` (launched by
// `hat_sample_pallas`) and `_fused_kernel` (launched by
// `hat_sample_fused`) in pnr_tpu/ops/pallas_sample.py. Both evaluate the
// trilinear ("hat") samples of the three channels (m1, m2, m3) of a tube
// map window that is stored x-major and channel-packed: element
// (z, y, 3*x + c) holds channel c at column x. For each row m with
// patch-relative coordinates (rz, ry, rx):
//
//   out[m, c] = sum_{a,b,d in {0,1}} w_z(a) w_y(b) w_x(d) P[z0+a, y0+b, 3(x0+d)+c]
//
// with z0 = floor(rz) and w_z(a) = max(0, 1 - |rz - (z0+a)|), likewise for
// y and x. The TPU kernels build dense (M, pz*py) weight matrices and split
// them into bf16 hi/lo halves only to feed the MXU; this file computes the
// f32 sum over the two non-zero taps per axis directly, one thread per
// row: 8 x 3 loads, grouped as the four (z, y) rows of six contiguous
// floats. The z/y weights multiply first and the x weights last, the order
// of the XLA hat-einsum the plain version runs.
//
// K5 reads the window from a materialised patch tensor (the tracer's
// `extract`); K6 reads it straight from the packed map field at the
// trace's corner, which is what the TPU could not express (Mosaic rejects
// DMA windows whose lane extent is not a multiple of 128). The field is
// 12*S bytes per voxel (1.9 GB at the 52.4-Mvox stack, S=3), so K6 indexes
// it in 64 bits.
//
// What bounds them on the H100: scattered 4-byte loads. A tracer
// iteration's windows (~73 MB of f32 patches for 128 traces at sigmas
// 2,4,6) are re-read from L2 by 180 rows per trace and sigma; a row's 24
// loads hit 4 cache lines. Staging each trace's window in shared memory
// and fusing the coordinate and correlation arithmetic in are later work.
//
// The caller clamps (rz, ry, rx) into [0, p - 1.001]; the integer corner
// is clamped again here to [0, p - 2] (and K6's window corner into the
// field) so that a bad coordinate can never read outside the window.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int tap0(float r, int p) {
  return min(max((int)floorf(r), 0), p - 2);
}

__device__ __forceinline__ float hat(float r, int k) {
  return fmaxf(0.0f, 1.0f - fabsf(r - (float)k));
}

// Trilinear samples of the three channels at r = (rz, ry, rx, _) in the
// window whose element (0, 0, 0) is at `w`, with z and y pitches in floats.
__device__ __forceinline__ float4 sample3(const float* __restrict__ w, long long zpitch,
                                          long long ypitch, int pz, int py, int px, float4 r) {
  const int z0 = tap0(r.x, pz), y0 = tap0(r.y, py), x0 = tap0(r.z, px);
  const float wz[2] = {hat(r.x, z0), hat(r.x, z0 + 1)};
  const float wy[2] = {hat(r.y, y0), hat(r.y, y0 + 1)};
  const float wx0 = hat(r.z, x0), wx1 = hat(r.z, x0 + 1);
  float a0[3] = {0.0f, 0.0f, 0.0f};  // x tap 0, per channel
  float a1[3] = {0.0f, 0.0f, 0.0f};  // x tap 1
  const float* base = w + (long long)z0 * zpitch + (long long)y0 * ypitch + 3 * x0;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float wzy = wz[a] * wy[b];
      const float* p = base + a * zpitch + b * ypitch;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a0[c] += wzy * __ldg(p + c);
        a1[c] += wzy * __ldg(p + 3 + c);
      }
    }
  }
  return make_float4(wx0 * a0[0] + wx1 * a1[0], wx0 * a0[1] + wx1 * a1[1],
                     wx0 * a0[2] + wx1 * a1[2], 0.0f);
}

// K5: patches (T*Sg, pz, py, 3px); rel/out (T*Sg, R, 4).
__global__ void hat_patch_kernel(const float* __restrict__ patches, int pz, int py, int px,
                                 const float4* __restrict__ rel, int R, long long n,
                                 float4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long ts = i / R;
  const long long ypitch = 3LL * px;
  const long long zpitch = (long long)py * ypitch;
  out[i] = sample3(patches + ts * pz * zpitch, zpitch, ypitch, pz, py, px, __ldg(rel + i));
}

// K6: maps (S, Z, Y, 3X); corners (T, 3) zyx; rel/out (T, S*Mr, 4), row
// block s of each trace samples sigma s.
__global__ void hat_field_kernel(const float* __restrict__ maps, int Z, int Y, int X,
                                 const int* __restrict__ corners, int S, int Mr, int pz, int py,
                                 int px, const float4* __restrict__ rel, long long n,
                                 float4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long rows = (long long)S * Mr;
  const long long t = i / rows;
  const int s = (int)((i - t * rows) / Mr);
  const int cz = min(max(__ldg(corners + 3 * t), 0), Z - pz);
  const int cy = min(max(__ldg(corners + 3 * t + 1), 0), Y - py);
  const int cx = min(max(__ldg(corners + 3 * t + 2), 0), X - px);
  const long long ypitch = 3LL * X;
  const long long zpitch = (long long)Y * ypitch;
  const float* w = maps + ((long long)s * Z + cz) * zpitch + (long long)cy * ypitch + 3LL * cx;
  out[i] = sample3(w, zpitch, ypitch, pz, py, px, __ldg(rel + i));
}

inline unsigned int blocks_for(long long n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// patches: float32 (T, Sg, pz, py, 3*px); rel, out: float32 (T, Sg, R, 4).
int pnr_hat_sample_patch(const void* patches, int T, int Sg, int pz, int py, int px,
                         const void* rel, int R, void* out, void* stream) {
  const long long n = (long long)T * Sg * R;
  if (n == 0) return 0;
  hat_patch_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)patches, pz, py, px, (const float4*)rel, R, n, (float4*)out);
  return (int)cudaGetLastError();
}

// maps: float32 (S, Z, Y, 3*X); corners: int32 (T, 3) zyx window origins;
// rel, out: float32 (T, S*Mr, 4); the window is (pz, py, px).
int pnr_hat_sample_field(const void* maps, int S, int Z, int Y, int X, const void* corners, int T,
                         const void* rel, int Mr, int pz, int py, int px, void* out,
                         void* stream) {
  const long long n = (long long)T * S * Mr;
  if (n == 0) return 0;
  hat_field_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)maps, Z, Y, X, (const int*)corners, S, Mr, pz, py, px,
      (const float4*)rel, n, (float4*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
