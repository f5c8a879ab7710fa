// 1-D and fused y-x correlations of the unfused Frangi for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of pnr_tpu/ops/pallas_conv.py:
// * K3, `_pallas_conv` (kernel body `_conv_kernel_factory`): one 1-D
//   correlation along one axis with edge-replicated borders; with
//   `grad_border` the first and last plane along the axis are doubled, so
//   the central-difference taps (-0.5, 0, 0.5) give jnp.gradient's
//   one-sided borders. `conv1d_axis_kernel` below: one thread per output
//   voxel, consecutive threads along x, the taps passed by value (they sit
//   in the constant bank, one broadcast per tap for the whole warp).
// * K4, `_pallas_conv_yx`: the y pass then the x pass of a separable
//   correlation, edge-replicated, with the y-smoothed plane kept out of
//   device memory. `conv_yx_kernel` below: one block per (z, y tile, x
//   tile) of kTileY x kTileX outputs. The block stages the edge-clamped
//   (kTileY + 2hy) x (kTileX + 2hx) input window in shared memory
//   (widening uint8 to float32 as it loads), runs the y pass into a shared
//   kTileY x (kTileX + 2hx) temporary and the x pass into device memory.
//   At hy = hx = 18 (sigma 6) that is 40 KB of shared memory for any
//   plane width, where the TPU kernel holds one whole z-plane.
//
// Both compute each output voxel by one code path that depends only on its
// coordinates: the clamped reads, the taps and their order are the same
// wherever the block borders fall, so a tile of the volume gives the same
// bits as the whole volume (the tiled Frangi engines rely on it). The sum
// runs in tap order with fused multiply-adds (nvcc contracts a*b + c by
// default; no fast math), so against the plain PyTorch versions, which
// round each product, it differs by about one ulp per tap.
//
// What bounds them on the H100 at (128, 640, 640):
// * K3 reads each input voxel once and writes each output once, 8 B/voxel
//   in float32 (5 from uint8): ~0.125 ms at 3.35 TB/s, against 2 FLOPs per
//   tap (74 for 37 taps, ~0.058 ms at 67 TFLOP/s). Bytes set the bound;
//   the kernel re-reads its neighbours through L1/L2, not device memory.
// * K4 does 2 FLOPs per tap in each pass, 148 FLOPs/voxel at 37 + 37 taps
//   (~0.116 ms) against 5 B/voxel from uint8 (~0.078 ms): FLOPs set the
//   bound. The staged window costs (kTileX + 2hx) / kTileX more y-pass work
//   (1.56x at hx = 18); a wider tile or a register-blocked y pass is later
//   work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 127;  // half-width 63: sigma <= 21 at 3 sigma
constexpr int kThreads = 256;
constexpr int kTileX = 64;
constexpr int kTileY = 32;
constexpr int kBlockX = 64;
constexpr int kBlockY = 4;

struct Taps {
  float t[kMaxTaps];
};

template <typename T>
__global__ void conv1d_axis_kernel(const T* __restrict__ in, float* __restrict__ out, int Z, int Y,
                                   int X, int axis, Taps taps, int ntaps, int grad_border) {
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
    acc = fmaf(taps.t[t], (float)__ldg(in + base + (long long)q * stride), acc);
  }
  if (grad_border && (pos == 0 || pos == len - 1)) acc *= 2.0f;
  out[i] = acc;
}

template <typename T>
__global__ void conv_yx_kernel(const T* __restrict__ in, float* __restrict__ out, int Y, int X,
                               Taps ky, int nky, Taps kx, int nkx) {
  extern __shared__ float smem[];
  const int hy = nky / 2, hx = nkx / 2;
  const int wx = kTileX + 2 * hx;  // window width (x)
  const int wy = kTileY + 2 * hy;  // window height (y)
  float* win = smem;               // wy x wx input window
  float* tmp = smem + wy * wx;     // kTileY x wx y-smoothed rows
  const int z = blockIdx.z;
  const int y0 = blockIdx.y * kTileY, x0 = blockIdx.x * kTileX;
  const T* plane = in + (long long)z * Y * X;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;

  for (int k = tid; k < wy * wx; k += kThreads) {
    const int wyy = k / wx, wxx = k - wyy * wx;
    const int gy = min(max(y0 + wyy - hy, 0), Y - 1);
    const int gx = min(max(x0 + wxx - hx, 0), X - 1);
    win[k] = (float)__ldg(plane + (long long)gy * X + gx);
  }
  __syncthreads();

  // y pass: tmp[r][c] = sum_j ky[j] * win[r + j][c]
  for (int k = tid; k < kTileY * wx; k += kThreads) {
    const int r = k / wx, c = k - r * wx;
    float acc = 0.0f;
    for (int j = 0; j < nky; ++j) acc = fmaf(ky.t[j], win[(r + j) * wx + c], acc);
    tmp[k] = acc;
  }
  __syncthreads();

  // x pass: out[y0 + r][x0 + c] = sum_j kx[j] * tmp[r][c + j]
  for (int r = threadIdx.y; r < kTileY; r += kBlockY) {
    const int gy = y0 + r;
    for (int c = threadIdx.x; c < kTileX; c += kBlockX) {
      const int gx = x0 + c;
      if (gy >= Y || gx >= X) continue;
      float acc = 0.0f;
      for (int j = 0; j < nkx; ++j) acc = fmaf(kx.t[j], tmp[r * wx + c + j], acc);
      out[((long long)z * Y + gy) * X + gx] = acc;
    }
  }
}

Taps load_taps(const float* host, int n) {
  Taps t = {};
  for (int i = 0; i < n; ++i) t.t[i] = host[i];
  return t;
}

inline unsigned int blocks_for(long long n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// K3: correlate a (Z, Y, X) uint8 (in_is_u8) or float32 volume along
// `axis` (0=z, 1=y, 2=x) with the `ntaps` (odd, <= 127) host taps,
// edge-replicated, into float32; `grad_border` doubles the end planes.
int pnr_conv1d_axis(const void* in, int in_is_u8, void* out, int Z, int Y, int X, int axis,
                    const float* taps, int ntaps, int grad_border, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || axis < 0 || axis > 2) return (int)cudaErrorInvalidValue;
  const long long n = (long long)Z * Y * X;
  const Taps t = load_taps(taps, ntaps);
  cudaStream_t s = (cudaStream_t)stream;
  if (in_is_u8) {
    conv1d_axis_kernel<unsigned char><<<blocks_for(n), kThreads, 0, s>>>(
        (const unsigned char*)in, (float*)out, Z, Y, X, axis, t, ntaps, grad_border);
  } else {
    conv1d_axis_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        (const float*)in, (float*)out, Z, Y, X, axis, t, ntaps, grad_border);
  }
  return (int)cudaGetLastError();
}

// K4: the y pass (nky host taps) then the x pass (nkx host taps) of a
// (Z, Y, X) uint8 or float32 volume, edge-replicated, into float32.
int pnr_conv_yx(const void* in, int in_is_u8, void* out, int Z, int Y, int X, const float* ky,
                int nky, const float* kx, int nkx, void* stream) {
  if (nky < 1 || nky > kMaxTaps || nkx < 1 || nkx > kMaxTaps) return (int)cudaErrorInvalidValue;
  const Taps ty = load_taps(ky, nky), tx = load_taps(kx, nkx);
  const int wx = kTileX + 2 * (nkx / 2), wy = kTileY + 2 * (nky / 2);
  const size_t smem = (size_t)(wy + kTileY) * wx * sizeof(float);
  const dim3 grid((X + kTileX - 1) / kTileX, (Y + kTileY - 1) / kTileY, Z);
  const dim3 block(kBlockX, kBlockY);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (in_is_u8) {
    err = cudaFuncSetAttribute(conv_yx_kernel<unsigned char>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    conv_yx_kernel<unsigned char><<<grid, block, smem, s>>>((const unsigned char*)in, (float*)out,
                                                            Y, X, ty, nky, tx, nkx);
  } else {
    err = cudaFuncSetAttribute(conv_yx_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    conv_yx_kernel<float><<<grid, block, smem, s>>>((const float*)in, (float*)out, Y, X, ty, nky,
                                                    tx, nkx);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
