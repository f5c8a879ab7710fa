// 1-D and fused y-x correlations of the unfused Frangi for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of pnr_tpu/ops/pallas_conv.py:
// * K3, `_pallas_conv` (kernel body `_conv_kernel_factory`): one 1-D
//   correlation along one axis with edge-replicated borders; with
//   `grad_border` the first and last plane along the axis are doubled, so
//   the central-difference taps (-0.5, 0, 0.5) give jnp.gradient's
//   one-sided borders. Two kernels on a 3-D grid:
//   - along z or y (`conv1d_axis_cols_kernel`): a thread owns one x, or
//     four x with 16-byte (float32) or 4-byte (uint8) loads where the rows
//     are aligned, and a run of kRunCols outputs along the axis. It loads
//     each input sample of its column once into a register window and
//     forms every output from it, so the loads per output fall from
//     `ntaps` to (kRunCols + 4 ceil(ntaps / 4)) / kRunCols; a warp's loads
//     are coalesced along x;
//   - along x (`conv1d_axis_x_kernel`): a warp loads a row segment of
//     kRowSeg outputs and its halo into shared memory, coalesced, and
//     each lane forms four consecutive outputs from 16-byte shared reads.
//   uint8 input is widened to float32 as it loads. The taps are a
//   `__grid_constant__` parameter: read from the constant bank with the
//   warp-uniform tap index, never copied to local memory (a by-value
//   struct indexed at run time is). Offsets within a column or row are
//   32-bit operands of one wide multiply; no thread divides a 64-bit
//   index.
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
// wherever the block borders or a thread's run fall, so a tile of the
// volume gives the same bits as the whole volume (the tiled Frangi engines
// rely on it). The sum runs in tap order with fused multiply-adds from 0
// (no fast math), so against the plain PyTorch versions, which round each
// product, it differs by about one ulp per tap.
//
// What bounds them on the H100 at (128, 640, 640):
// * K3 reads each input voxel once and writes each output once, 8 B/voxel
//   in float32 (5 from uint8): ~0.125 ms at 3.35 TB/s, against 2 FLOPs per
//   tap (74 for 37 taps, ~0.058 ms at 67 TFLOP/s). Bytes set the bound.
//   The register window keeps the re-reads of a column's neighbours in
//   registers (at 19 taps and kRunCols = 8: 3.5 loads an output, from L1
//   and L2, not device memory), and the four-wide lanes move 16 bytes a
//   load, so the kernel streams near the device-memory rate.
// * K4 does 2 FLOPs per tap in each pass, 148 FLOPs/voxel at 37 + 37 taps
//   (~0.116 ms) against 5 B/voxel from uint8 (~0.078 ms): FLOPs set the
//   bound. The staged window costs (kTileX + 2hx) / kTileX more y-pass work
//   (1.56x at hx = 18); a wider tile or a register-blocked y pass is later
//   work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 127;  // half-width 63: sigma <= 21 at 3 sigma
constexpr int kRunCols = 8;    // outputs a thread forms along z or y
constexpr int kColsX = 32;     // threads of a column block along x
constexpr int kColsO = 4;      // threads of a column block along the other axis
constexpr int kRowSeg = 128;   // x outputs of one warp in the x kernel (4 a lane)
constexpr int kRows = 8;       // rows (warps) of an x-kernel block
constexpr int kThreads = 256;
constexpr int kTileX = 64;
constexpr int kTileY = 32;
constexpr int kBlockX = 64;
constexpr int kBlockY = 4;

struct Taps {
  float t[kMaxTaps];
};

__device__ __forceinline__ int clampi(int q, int n) { return min(max(q, 0), n - 1); }

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const unsigned char* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uchar4 a = __ldg(reinterpret_cast<const uchar4*>(p));
    v[0] = (float)a.x; v[1] = (float)a.y; v[2] = (float)a.z; v[3] = (float)a.w;
  } else {
    v[0] = (float)__ldg(p);
  }
}

// K3 along z or y. Thread (x, o) owns the column of positions p along the
// axis at element offset o * ostride + x + p * stride (o: y for axis 0, z
// for axis 1), VEC columns wide, and the outputs p0 .. p0 + kRunCols - 1,
// p0 = blockIdx.x * kRunCols: the runs of one column are neighbours in the
// grid, so their overlapping reads meet in L2. e[j] holds position
// p0 - half + g + j while taps g .. g + 3 are applied.
template <typename T, int VEC>
__global__ void __launch_bounds__(kColsX * kColsO)
conv1d_axis_cols_kernel(const T* __restrict__ in, float* __restrict__ out, int len, int nother,
                        int X, unsigned stride, unsigned ostride,
                        const __grid_constant__ Taps taps, int ntaps, int grad_border) {
  const int x = (blockIdx.y * kColsX + threadIdx.x) * VEC;
  const int o = blockIdx.z * kColsO + threadIdx.y;
  if (x >= X || o >= nother) return;
  const size_t col = (size_t)o * ostride + (unsigned)x;
  const T* src = in + col;
  const int p0 = blockIdx.x * kRunCols;
  const int q0 = p0 - (ntaps >> 1);
  float acc[kRunCols][VEC];
  float e[kRunCols + 4][VEC];
#pragma unroll
  for (int r = 0; r < kRunCols; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.0f;
#pragma unroll
  for (int j = 0; j < kRunCols + 4; ++j)
    load_vec<VEC>(src + (size_t)(unsigned)clampi(q0 + j, len) * stride, e[j]);
  for (int g = 0; g < ntaps; g += 4) {
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      if (g + tt < ntaps) {
        const float k = taps.t[g + tt];
#pragma unroll
        for (int r = 0; r < kRunCols; ++r)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(k, e[tt + r][v], acc[r][v]);
      }
    }
    if (g + 4 < ntaps) {
#pragma unroll
      for (int j = 0; j < kRunCols; ++j)
#pragma unroll
        for (int v = 0; v < VEC; ++v) e[j][v] = e[j + 4][v];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        load_vec<VEC>(src + (size_t)(unsigned)clampi(q0 + g + 4 + kRunCols + j, len) * stride,
                      e[kRunCols + j]);
    }
  }
  float* dst = out + col;
#pragma unroll
  for (int r = 0; r < kRunCols; ++r) {
    const int p = p0 + r;
    if (p < len) {
      const bool twice = grad_border && (p == 0 || p == len - 1);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        if (twice) acc[r][v] *= 2.0f;
      float* d = dst + (size_t)(unsigned)p * stride;
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(d) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      else
        *d = acc[r][0];
    }
  }
}

// K3 along x. Warp threadIdx.y of block (bx, by, z) takes row (z, y =
// by * kRows + threadIdx.y) and its outputs x0 .. x0 + kRowSeg - 1, x0 =
// bx * kRowSeg: it loads the edge-clamped inputs x0 - half .. into its
// shared segment, and lane l forms outputs x0 + 4l .. x0 + 4l + 3 from the
// 16-byte words l + g / 4 and l + g / 4 + 1 while taps g .. g + 3 apply.
template <typename T>
__global__ void __launch_bounds__(32 * kRows)
conv1d_axis_x_kernel(const T* __restrict__ in, float* __restrict__ out, int Y, int X,
                     const __grid_constant__ Taps taps, int ntaps, int grad_border) {
  extern __shared__ __align__(16) float seg[];
  const int w = kRowSeg + 4 * ((ntaps + 3) >> 2);
  const int y = blockIdx.y * kRows + threadIdx.y;
  if (y >= Y) return;  // the whole warp: the block never synchronises
  const int x0 = blockIdx.x * kRowSeg;
  const size_t row = ((size_t)blockIdx.z * (unsigned)Y + (unsigned)y) * (unsigned)X;
  const T* src = in + row;
  float* s = seg + threadIdx.y * w;
  const int lo = x0 - (ntaps >> 1);
  for (int j = threadIdx.x; j < w; j += 32) s[j] = (float)__ldg(src + clampi(lo + j, X));
  __syncwarp();
  const float4* s4 = reinterpret_cast<const float4*>(s) + threadIdx.x;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float4 a = s4[0];
  for (int g = 0; g < ntaps; g += 4) {
    const float4 b = s4[(g >> 2) + 1];
    const float e[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      if (g + tt < ntaps) {
        const float k = taps.t[g + tt];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r] = fmaf(k, e[tt + r], acc[r]);
      }
    }
    a = b;
  }
  const int xo = x0 + 4 * threadIdx.x;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (grad_border && (xo + r == 0 || xo + r == X - 1)) acc[r] *= 2.0f;
  float* d = out + row + xo;
  if ((X & 3) == 0 && xo + 4 <= X) {
    *reinterpret_cast<float4*>(d) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (xo + r < X) d[r] = acc[r];
  }
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

// K3's launch (ops/conv.conv1d_plan mirrors it): grid, block, dynamic
// shared memory, columns a thread owns (cols kernel) and whether it fits
// the grid's limits.
struct Launch {
  dim3 grid, block;
  int smem, vec;
  bool ok;
};

Launch conv1d_launch(int Z, int Y, int X, int axis, int ntaps, bool vec4) {
  Launch l{};
  const long long plane = (long long)Y * X;
  if (axis == 2) {
    l.grid = dim3((X + kRowSeg - 1) / kRowSeg, (Y + kRows - 1) / kRows, Z);
    l.block = dim3(32, kRows, 1);
    l.smem = kRows * (kRowSeg + 4 * ((ntaps + 3) / 4)) * (int)sizeof(float);
    l.vec = 1;
  } else {
    const int len = axis == 0 ? Z : Y, nother = axis == 0 ? Y : Z;
    l.vec = vec4 ? 4 : 1;
    l.grid = dim3((len + kRunCols - 1) / kRunCols, (X + kColsX * l.vec - 1) / (kColsX * l.vec),
                  (nother + kColsO - 1) / kColsO);
    l.block = dim3(kColsX, kColsO, 1);
    l.smem = 0;
  }
  l.ok = plane < (1LL << 32) && l.grid.y <= 65535 && l.grid.z <= 65535;
  return l;
}

template <typename T>
cudaError_t launch_conv1d(const T* in, float* out, int Z, int Y, int X, int axis, const Taps& t,
                          int ntaps, int grad_border, cudaStream_t s) {
  const bool vec4 = (X % 4) == 0 && (reinterpret_cast<uintptr_t>(in) % (4 * sizeof(T))) == 0;
  const Launch l = conv1d_launch(Z, Y, X, axis, ntaps, vec4);
  if (!l.ok) return cudaErrorInvalidValue;
  if (axis == 2) {
    conv1d_axis_x_kernel<T><<<l.grid, l.block, l.smem, s>>>(in, out, Y, X, t, ntaps, grad_border);
  } else {
    const int len = axis == 0 ? Z : Y, nother = axis == 0 ? Y : Z;
    const unsigned plane = (unsigned)((long long)Y * X);
    const unsigned stride = axis == 0 ? plane : (unsigned)X;
    const unsigned ostride = axis == 0 ? (unsigned)X : plane;
    if (l.vec == 4)
      conv1d_axis_cols_kernel<T, 4><<<l.grid, l.block, 0, s>>>(in, out, len, nother, X, stride,
                                                               ostride, t, ntaps, grad_border);
    else
      conv1d_axis_cols_kernel<T, 1><<<l.grid, l.block, 0, s>>>(in, out, len, nother, X, stride,
                                                               ostride, t, ntaps, grad_border);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3: correlate a (Z, Y, X) uint8 (in_is_u8) or float32 volume along
// `axis` (0=z, 1=y, 2=x) with the `ntaps` (odd, <= 127) host taps,
// edge-replicated, into float32; `grad_border` doubles the end planes.
int pnr_conv1d_axis(const void* in, int in_is_u8, void* out, int Z, int Y, int X, int axis,
                    const float* taps, int ntaps, int grad_border, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || ntaps % 2 == 0 || axis < 0 || axis > 2)
    return (int)cudaErrorInvalidValue;
  const Taps t = load_taps(taps, ntaps);
  cudaStream_t s = (cudaStream_t)stream;
  if (in_is_u8)
    return (int)launch_conv1d((const unsigned char*)in, (float*)out, Z, Y, X, axis, t, ntaps,
                              grad_border, s);
  return (int)launch_conv1d((const float*)in, (float*)out, Z, Y, X, axis, t, ntaps, grad_border,
                            s);
}

// K3's launch for a (Z, Y, X) volume: out[0..8] = grid x, y, z, block x,
// y, z, dynamic shared bytes, columns a thread owns, and 1 if it fits.
int pnr_conv1d_plan(int Z, int Y, int X, int axis, int ntaps, int vec4, int* out) {
  const Launch l = conv1d_launch(Z, Y, X, axis, ntaps, vec4 != 0);
  const int v[9] = {(int)l.grid.x, (int)l.grid.y, (int)l.grid.z, (int)l.block.x,
                    (int)l.block.y, (int)l.block.z, l.smem, l.vec, (int)l.ok};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
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
