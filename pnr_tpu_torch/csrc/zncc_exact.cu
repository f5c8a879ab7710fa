// Exact template ZNCC sums for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_exact_kernel` launched by
// `_exact_sums_pallas` in pnr_tpu/ops/zncc_exact.py. That kernel
// contracts z-sorted 512-sample template blocks against a VMEM-resident
// f32 patch on the MXU with bf16-split hat weights. Here one thread block
// evaluates one (trace, particle) query: its threads stride over each
// sigma's template samples (v, u, w, g), form the patch-relative sample
// coordinate exactly as `_qinfo` packs it, clamp it to [0, hi], sample the
// uint8 volume trilinearly at corner + floor(rel) (fractions in the patch
// frame), and accumulate A = sum(I - m0), B = sum((I - m0)^2),
// C = sum((I - m0) * g) in float32. A warp-shuffle block reduction writes
// (A, B, C, 0) per sigma. This is the f32 math of `_exact_sums_xla`.
//
// What bounds it on the H100: the 8 scattered byte loads per sample. At
// the README's sigmas (2, 4, 6) a query touches ~12k samples (~96k loads);
// a 128-trace x 21-query tracer iteration is ~260M loads, served almost
// entirely from L1/L2 because each trace's particles share one ~400 KB
// u8 patch window and a 52 MB stack nearly fits the 50 MB L2. The patch
// never exists as an f32 array (the TPU's f32 patches were forced by
// Mosaic's alignment rules). Staging each trace's z window in shared
// memory is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// query columns, as packed by ExactPatchEngine.qinfo (pnr_tpu _qinfo)
enum {
  Q_RZ = 0, Q_NDZ, Q_WZ,
  Q_RY, Q_NDY, Q_WY,
  Q_RX, Q_NDX, Q_WX,
  Q_UY, Q_UX,
  Q_M0, Q_ZHI, Q_YHI, Q_XHI,
  Q_COLS = 16
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void exact_sums_kernel(const unsigned char* __restrict__ vol, int Z, int Y, int X,
                                  const int* __restrict__ corner, const float* __restrict__ qs,
                                  int B, const float4* __restrict__ tab,
                                  const int* __restrict__ cnt, int S, int Kmax,
                                  float* __restrict__ out) {
  __shared__ float red[3][kThreads / 32];
  const int tb = blockIdx.x;
  const int t = tb / B;
  const float* q = qs + (long long)tb * Q_COLS;
  const float rzp = __ldg(q + Q_RZ), ndz = __ldg(q + Q_NDZ), wz = __ldg(q + Q_WZ);
  const float ryp = __ldg(q + Q_RY), ndy = __ldg(q + Q_NDY), wy = __ldg(q + Q_WY);
  const float rxp = __ldg(q + Q_RX), ndx = __ldg(q + Q_NDX), wx = __ldg(q + Q_WX);
  const float uy = __ldg(q + Q_UY), ux = __ldg(q + Q_UX);
  const float m0 = __ldg(q + Q_M0);
  const float zhi = __ldg(q + Q_ZHI), yhi = __ldg(q + Q_YHI), xhi = __ldg(q + Q_XHI);
  const long long plane = (long long)Y * X;
  const unsigned char* base =
      vol + (long long)__ldg(corner + 3 * t) * plane +
      (long long)__ldg(corner + 3 * t + 1) * X + __ldg(corner + 3 * t + 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int s = 0; s < S; ++s) {
    float a = 0.0f, b = 0.0f, c = 0.0f;
    const int k_n = __ldg(cnt + s);
    const float4* row = tab + (long long)s * Kmax;
    for (int k = threadIdx.x; k < k_n; k += kThreads) {
      const float4 e = __ldg(row + k);  // (v, u, w, g)
      const float rz = fminf(fmaxf(rzp + e.x * ndz + e.z * wz, 0.0f), zhi);
      const float ry = fminf(fmaxf(ryp + e.x * ndy + e.y * uy + e.z * wy, 0.0f), yhi);
      const float rx = fminf(fmaxf(rxp + e.x * ndx + e.y * ux + e.z * wx, 0.0f), xhi);
      const float z1f = floorf(rz), y1f = floorf(ry), x1f = floorf(rx);
      const float zf = rz - z1f, yf = ry - y1f, xf = rx - x1f;
      const unsigned char* p = base + (long long)z1f * plane + (long long)y1f * X + (int)x1f;
      const float r11a = __ldg(p), r11b = __ldg(p + 1);
      const float r21a = __ldg(p + X), r21b = __ldg(p + X + 1);
      const float r12a = __ldg(p + plane), r12b = __ldg(p + plane + 1);
      const float r22a = __ldg(p + plane + X), r22b = __ldg(p + plane + X + 1);
      const float plane1 = (1.0f - yf) * ((1.0f - xf) * r11a + xf * r11b) +
                           yf * ((1.0f - xf) * r21a + xf * r21b);
      const float plane2 = (1.0f - yf) * ((1.0f - xf) * r12a + xf * r12b) +
                           yf * ((1.0f - xf) * r22a + xf * r22b);
      const float val = ((1.0f - zf) * plane1 + zf * plane2) - m0;
      a += val;
      b += val * val;
      c += val * e.w;
    }
    a = warp_sum(a);
    b = warp_sum(b);
    c = warp_sum(c);
    if (lane == 0) {
      red[0][warp] = a;
      red[1][warp] = b;
      red[2][warp] = c;
    }
    __syncthreads();
    if (warp == 0) {
      a = lane < kThreads / 32 ? red[0][lane] : 0.0f;
      b = lane < kThreads / 32 ? red[1][lane] : 0.0f;
      c = lane < kThreads / 32 ? red[2][lane] : 0.0f;
      a = warp_sum(a);
      b = warp_sum(b);
      c = warp_sum(c);
      if (lane == 0) {
        float* o = out + ((long long)tb * S + s) * 4;
        o[0] = a;
        o[1] = b;
        o[2] = c;
        o[3] = 0.0f;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// vol: uint8 (Z, Y, X); corner: int32 (T, 3) zyx; qs: float32 (T, B, 16);
// tab: float32 (S, Kmax, 4) rows (v, u, w, g); cnt: int32 (S,);
// out: float32 (T, B, S, 4).
int pnr_exact_sums(const void* vol, int Z, int Y, int X, const void* corner, const void* qs,
                   int T, int B, const void* tab, const void* cnt, int S, int Kmax, void* out,
                   void* stream) {
  const long long nblk = (long long)T * B;
  if (nblk == 0) return 0;
  exact_sums_kernel<<<(unsigned int)nblk, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)vol, Z, Y, X, (const int*)corner, (const float*)qs, B,
      (const float4*)tab, (const int*)cnt, S, Kmax, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
