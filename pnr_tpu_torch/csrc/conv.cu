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
//   device memory. `conv_yx_kernel`: a 256-thread block walks a run of y
//   tiles of ty x 128 outputs (ty 64, 32 or 16: the tallest whose shared
//   memory lets four blocks share an SM) down one x tile of one plane. It
//   stages the edge-clamped input rows in shared memory in the input's
//   own type, with 16-byte `cp.async` from each row's aligned chunk (rows
//   start at any byte: a table holds each row's offset; columns outside
//   the volume take the edge value), into a ring that holds the current
//   tile's window and the next tile's new rows, which are in flight while
//   the block works. The y pass is register-blocked: a thread slides a
//   register window down one window column and forms kYxRun = 16 rows, so
//   it reads (16 + 4 ceil(nky / 4)) / 16 window values an output, not
//   nky; it covers the window's 128 + nkx - 1 columns (1.28x the outputs
//   at sigma 6). In the x pass a half-warp takes a row and a lane forms 8
//   outputs from a register window of float4 reads of the y-smoothed row.
//   The taps are staged in shared memory and read as float4.
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
//   bound. The kernel issues ~1.28 nky + nkx fused multiply-adds a voxel
//   (the y pass's halo columns), ~2/3 of its y pass's instructions and
//   ~9/10 of its x pass's. Per 4 taps the y pass makes 6 shared reads (4
//   values, the int4 of row offsets, the float4 of taps) for 64 of them
//   and the x pass a float4 of values and one of taps for 32. Narrower
//   runs and lanes (8 rows, 4 outputs) kept the shared-memory pipe nearly
//   as busy as the FMA pipes and were slower on the card (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kMaxTaps = 127;  // half-width 63: sigma <= 21 at 3 sigma
constexpr int kRunCols = 8;    // outputs a thread forms along z or y
constexpr int kColsX = 32;     // threads of a column block along x
constexpr int kColsO = 4;      // threads of a column block along the other axis
constexpr int kRowSeg = 128;   // x outputs of one warp in the x kernel (4 a lane)
constexpr int kRows = 8;       // rows (warps) of an x-kernel block
constexpr int kYxTileX = 128;  // x outputs of a K4 block: four a lane of one warp
constexpr int kYxRun = 16;     // y-pass outputs a K4 thread forms down its column
constexpr int kYxLane = 8;     // x-pass outputs a K4 lane forms along its row (16 lanes a row)
constexpr int kYxWarps = 8;
constexpr int kYxThreads = 32 * kYxWarps;
constexpr int kSmemLimit = 232448;  // shared memory a block can take
constexpr int kYxBlocks = 132 * 16;  // K4's grid: ~16 blocks on each of the H100's SMs
// K4's tile heights, tallest first: the tallest whose block takes at most
// a quarter of the shared memory (four blocks an SM), else the last
constexpr int kYxTileYs[] = {64, 32, 16};

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

// K4's block geometry for tiles of ty x kYxTileX outputs (size: bytes of
// an input element), in the order of its dynamic shared memory:
// * the y and x taps, each padded to a multiple of 4 (read as float4);
// * `rows` int offsets of the current window's rows: the byte offset in
//   the ring of window column 0 of each row (ty + 4 ceil(nky / 4) rows:
//   the y pass's register window reads up to 4 rows past the last it
//   uses, which it never multiplies; they fall on slots of the next
//   tile's rows);
// * `nring` int offsets of the ring's slots (padded to a multiple of 4);
// * the y-smoothed rows, ty x tmpw float32 (tmpw = kYxTileX + 4 ceil(nkx
//   / 4): the x pass's float4 reads run up to 4 columns past the last it
//   uses);
// * the ring of input rows, nring = 2 ty + nky - 1 slots of `pitch` bytes:
//   the current tile's window (ty + nky - 1 rows) and the next tile's ty
//   new rows. A slot holds a margin that takes the columns left of the
//   volume, then the row's 16-byte chunks, read at the row's lead (its
//   first byte's address mod 16).
// The y pass forms `ncols` = kYxTileX + nkx - 1 columns: the x pass's
// reach. ops/conv.yx_geom mirrors it.
struct YxGeom {
  int ty, ncols, rows, nring, margin, pitch, tmpw, smem;
};

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

__host__ __device__ __forceinline__ YxGeom yx_geom(int nky, int nkx, int size, int ty) {
  YxGeom g;
  g.ty = ty;
  g.ncols = kYxTileX + nkx - 1;
  g.rows = ty + 4 * ((nky + 3) / 4);
  g.nring = 2 * ty + nky - 1;
  g.margin = round16((nkx / 2) * size);
  g.pitch = g.margin + round16(g.ncols * size + 15);
  g.tmpw = kYxTileX + 4 * ((nkx + 3) / 4);
  g.smem = 16 * ((nky + 3) / 4 + (nkx + 3) / 4) + 4 * g.rows + 16 * ((g.nring + 3) / 4) +
           4 * ty * g.tmpw + g.nring * g.pitch;
  return g;
}

template <typename T>
__device__ __forceinline__ float lds(const unsigned char* p) {
  return (float)*reinterpret_cast<const T*>(p);
}

// One group of 4 y taps (k) on a thread's register window e0 | .. | e4
// (window rows 4q .. 4q + 19 of its run: output u takes row 4q + t + u for
// tap 4q + t); `nt` < 4 applies only the first nt. The last group of a
// sum has nt = nky mod 4 (1 or 3: nky is odd).
__device__ __forceinline__ void y_group(const float4 k, const float (&e0)[4], const float (&e1)[4],
                                        const float (&e2)[4], const float (&e3)[4],
                                        const float (&e4)[4], float (&acc)[kYxRun], int nt) {
  const float e[20] = {e0[0], e0[1], e0[2], e0[3], e1[0], e1[1], e1[2], e1[3], e2[0], e2[1],
                       e2[2], e2[3], e3[0], e3[1], e3[2], e3[3], e4[0], e4[1], e4[2], e4[3]};
  const float kk[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t < nt) {
#pragma unroll
      for (int u = 0; u < kYxRun; ++u) acc[u] = fmaf(kk[t], e[t + u], acc[u]);
    }
  }
}

// Load the 4 window rows whose offsets `o` holds, column `col`, into e.
template <typename T>
__device__ __forceinline__ void y_load(const unsigned char* col, const int4 o, float (&e)[4]) {
  e[0] = lds<T>(col + o.x);
  e[1] = lds<T>(col + o.y);
  e[2] = lds<T>(col + o.z);
  e[3] = lds<T>(col + o.w);
}

// One group of 4 x taps on a lane's y-smoothed values e0 | e1 | e2
// (columns 4q .. 4q + 11 of its run of 8 outputs: output u takes column
// 4q + t + u for tap 4q + t); `nt` < 4 applies only the first nt.
__device__ __forceinline__ void x_group(const float4 k, const float4 e0, const float4 e1,
                                        const float4 e2, float (&acc)[kYxLane], int nt) {
  const float e[12] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w, e2.x, e2.y, e2.z, e2.w};
  const float kk[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t < nt) {
#pragma unroll
      for (int u = 0; u < kYxLane; ++u) acc[u] = fmaf(kk[t], e[t + u], acc[u]);
    }
  }
}

// Start copying window rows j = j0 .. j1 - 1 of a block's walk (global
// row clamp(yb - hy + j)) into their ring slots (slot j mod nring, s0 =
// j0 mod nring), warp w taking rows j0 + w, j0 + w + 8, ..., with 16-byte
// cp.async from the chunk at or below the row's first in-volume byte
// (gxa); records each slot's offset of window column 0.
template <typename T>
__device__ __forceinline__ void yx_stage(unsigned char* ring, int* slotoff, const T* plane,
                                         const YxGeom& g, int Y, int X, int yb, int hy, int j0,
                                         int j1, int s0, int gxa, int nleft, int len) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = j0 + warp; j < j1; j += kYxWarps) {
    int slot = s0 + (j - j0);
    if (slot >= g.nring) slot -= g.nring;
    const int gy = clampi(yb - hy + j, Y);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(plane + (size_t)(unsigned)gy * (unsigned)X + gxa);
    const int lead = (int)(reinterpret_cast<uintptr_t>(src) & 15);
    const int nch = (lead + len + 15) >> 4;
    const int off = slot * g.pitch + g.margin;
    for (int c = lane; c < nch; c += 32) cp_async16(ring + off + 16 * c, src - lead + 16 * c);
    if (lane == 0) slotoff[slot] = off + lead - nleft * (int)sizeof(T);
  }
}

// K4. Block (bx, by, z) walks the y tiles t0 .. t1 - 1 (t0 = by * tiles)
// of the x tile x0 = bx * kYxTileX in plane z; for tile t it forms the
// outputs (z, t ty .. t ty + ty - 1, x0 .. x0 + kYxTileX - 1):
// 1. staging: the taps go to shared memory; the block's first window
//    (global rows clamp(t0 ty - hy + j), j < ty + nky - 1; columns x0 - hx
//    .. x0 - hx + ncols - 1) is copied into the ring (yx_stage), and while
//    it works on tile t the ty rows that tile t + 1 adds are in flight into
//    the slots of the rows that tile t no longer reads; landed rows'
//    columns outside the volume take the edge value, and the window's
//    rows get their slots' offsets;
// 2. y pass: thread i takes the (column, run) items i, i + 256, ... of the
//    ncols x (ty / kYxRun) items (stepped without division) and forms
//    kYxRun rows of its column from a register window of 20 rows that it
//    fills down the column, 4 rows a tap group, through the row offsets
//    (int4); the five quarters of the window take turns, so no value
//    moves;
// 3. x pass: half-warp h of warp w takes rows 2w + h, 2w + h + 16, ... and
//    its lane l forms outputs x0 + 8l .. x0 + 8l + 7 from a register
//    window of three float4 of its y-smoothed row, which take turns.
// The taps are read as float4 from shared memory (one broadcast read a
// group). Each sum is fused multiply-adds in tap order from 0: the y
// output over the clamped inputs, the x output over the y outputs.
template <typename T>
__global__ void __launch_bounds__(kYxThreads, 4)
conv_yx_kernel(const T* __restrict__ in, float* __restrict__ out, int Y, int X,
               const __grid_constant__ YxGeom g, int tiles, const __grid_constant__ Taps ky,
               int nky, const __grid_constant__ Taps kx, int nkx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ty = g.ty;
  const int ngy = (nky + 3) >> 2, ngx = (nkx + 3) >> 2;  // tap groups
  float* sky = reinterpret_cast<float*>(smem);
  float* skx = sky + 4 * ngy;
  int* rowoff = reinterpret_cast<int*>(skx + 4 * ngx);
  int* slotoff = rowoff + g.rows;
  float* tmp = reinterpret_cast<float*>(slotoff + 4 * ((g.nring + 3) >> 2));
  unsigned char* ring = reinterpret_cast<unsigned char*>(tmp + ty * g.tmpw);
  const int hy = nky >> 1, hx = nkx >> 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int z = blockIdx.z, x0 = blockIdx.x * kYxTileX;
  const int t0 = blockIdx.y * tiles, nt = min(tiles, (Y + ty - 1) / ty - t0);
  const int yb = t0 * ty;
  const int cx = x0 - hx;  // the global x of window column 0
  const int gxa = max(cx, 0), gxb = min(cx + g.ncols - 1, X - 1);
  const int nleft = gxa - cx, clast = gxb - cx;
  const bool xedge = nleft > 0 || clast < g.ncols - 1;
  const int len = (gxb - gxa + 1) * (int)sizeof(T);
  const int staged = ty + nky - 1;
  const T* plane = in + (size_t)z * (unsigned)Y * (unsigned)X;

  for (int i = threadIdx.x; i < 4 * ngy; i += kYxThreads) sky[i] = i < nky ? ky.t[i] : 0.0f;
  for (int i = threadIdx.x; i < 4 * ngx; i += kYxThreads) skx[i] = i < nkx ? kx.t[i] : 0.0f;
  // the slots the first window leaves empty need a valid offset, as the
  // y pass's register window may read them (never to multiply): the first
  // step's copies record theirs, so only a walk of one tile sets them here
  // (no other thread writes them then)
  if (nt == 1)
    for (int s = staged + threadIdx.x; s < g.nring; s += kYxThreads)
      slotoff[s] = s * g.pitch + g.margin;
  yx_stage(ring, slotoff, plane, g, Y, X, yb, hy, 0, staged, 0, gxa, nleft, len);
  cp_async_commit();
  const float4* ky4 = reinterpret_cast<const float4*>(sky);
  const float4* kx4 = reinterpret_cast<const float4*>(skx);
  const int4* ro4 = reinterpret_cast<const int4*>(rowoff);
  const int fully = nky >> 2, party = nky & 3, fullx = nkx >> 2, partx = nkx & 3;
  const int nruns = ty / kYxRun;
  int s_win = 0;             // slot of the current window's row 0
  int s_new = staged;        // slot of the next tile's first new row
  if (s_new >= g.nring) s_new -= g.nring;

  for (int k = 0; k < nt; ++k) {
    // the rows that landed for this window: all of it, then ty a tile
    const int j_hi = k * ty + staged, j_lo = k == 0 ? 0 : j_hi - ty;
    if (k + 1 < nt)
      yx_stage(ring, slotoff, plane, g, Y, X, yb, hy, j_hi, j_hi + ty, s_new, gxa, nleft, len);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (xedge) {
      int s = s_win + (j_lo - k * ty);
      if (s >= g.nring) s -= g.nring;
      for (int j = warp; j < j_hi - j_lo; j += kYxWarps) {
        int sj = s + j;
        if (sj >= g.nring) sj -= g.nring;
        T* row = reinterpret_cast<T*>(ring + slotoff[sj]);
        const T a = row[nleft], b = row[clast];
        for (int c = lane; c < nleft; c += 32) row[c] = a;
        for (int c = clast + 1 + lane; c < g.ncols; c += 32) row[c] = b;
      }
    }
    for (int r = threadIdx.x; r < g.rows; r += kYxThreads) {
      int sr = s_win + r;
      while (sr >= g.nring) sr -= g.nring;
      rowoff[r] = slotoff[sr];
    }
    __syncthreads();

    // y pass: tmp[r][c] = sum_j ky[j] * win[r + j][c]. nky is odd, so the
    // last group is partial and every full group loads the next 4 rows.
    int c = threadIdx.x, run = 0;
    while (c >= g.ncols) {
      c -= g.ncols;
      ++run;
    }
    while (run < nruns) {
      const int r0 = run * kYxRun;
      const unsigned char* col = ring + c * (int)sizeof(T);
      const int4* ro = ro4 + (r0 >> 2);
      float acc[kYxRun], A[4], B[4], C[4], D[4], E[4];
#pragma unroll
      for (int u = 0; u < kYxRun; ++u) acc[u] = 0.0f;
      y_load<T>(col, ro[0], A);
      y_load<T>(col, ro[1], B);
      y_load<T>(col, ro[2], C);
      y_load<T>(col, ro[3], D);
      y_load<T>(col, ro[4], E);
      int q = 0;
      for (; q + 5 <= fully; q += 5) {
        y_group(ky4[q], A, B, C, D, E, acc, 4);
        y_load<T>(col, ro[q + 5], A);
        y_group(ky4[q + 1], B, C, D, E, A, acc, 4);
        y_load<T>(col, ro[q + 6], B);
        y_group(ky4[q + 2], C, D, E, A, B, acc, 4);
        y_load<T>(col, ro[q + 7], C);
        y_group(ky4[q + 3], D, E, A, B, C, acc, 4);
        y_load<T>(col, ro[q + 8], D);
        y_group(ky4[q + 4], E, A, B, C, D, acc, 4);
        y_load<T>(col, ro[q + 9], E);
      }
      const int rem = fully - q;
      if (rem == 0) {
        y_group(ky4[q], A, B, C, D, E, acc, party);
      } else {
        y_group(ky4[q], A, B, C, D, E, acc, 4);
        y_load<T>(col, ro[q + 5], A);
        if (rem == 1) {
          y_group(ky4[q + 1], B, C, D, E, A, acc, party);
        } else {
          y_group(ky4[q + 1], B, C, D, E, A, acc, 4);
          y_load<T>(col, ro[q + 6], B);
          if (rem == 2) {
            y_group(ky4[q + 2], C, D, E, A, B, acc, party);
          } else {
            y_group(ky4[q + 2], C, D, E, A, B, acc, 4);
            y_load<T>(col, ro[q + 7], C);
            if (rem == 3) {
              y_group(ky4[q + 3], D, E, A, B, C, acc, party);
            } else {
              y_group(ky4[q + 3], D, E, A, B, C, acc, 4);
              y_load<T>(col, ro[q + 8], D);
              y_group(ky4[q + 4], E, A, B, C, D, acc, party);
            }
          }
        }
      }
      float* t = tmp + r0 * g.tmpw + c;
#pragma unroll
      for (int u = 0; u < kYxRun; ++u) t[u * g.tmpw] = acc[u];
      c += kYxThreads;
      while (c >= g.ncols) {
        c -= g.ncols;
        ++run;
      }
    }
    __syncthreads();

    // x pass: out[y0 + r][x0 + 8l' + u] = sum_j kx[j] * tmp[r][8l' + u + j],
    // l' = lane mod 16: a half-warp takes a row, a lane 8 outputs from a
    // register window of three float4 that take turns
    const int y0 = yb + k * ty;
    for (int r = 2 * warp + (lane >> 4); r < ty; r += 2 * kYxWarps) {
      const int gy = y0 + r;
      if (gy >= Y) break;
      const float4* s4 = reinterpret_cast<const float4*>(tmp + r * g.tmpw) + 2 * (lane & 15);
      float acc[kYxLane];
#pragma unroll
      for (int u = 0; u < kYxLane; ++u) acc[u] = 0.0f;
      float4 a = s4[0], b = s4[1], c = s4[2];
      int q = 0;
      for (; q + 3 <= fullx; q += 3) {
        x_group(kx4[q], a, b, c, acc, 4);
        a = s4[q + 3];
        x_group(kx4[q + 1], b, c, a, acc, 4);
        b = s4[q + 4];
        x_group(kx4[q + 2], c, a, b, acc, 4);
        c = s4[q + 5];
      }
      if (q == fullx) {
        x_group(kx4[q], a, b, c, acc, partx);
      } else if (q + 1 == fullx) {
        x_group(kx4[q], a, b, c, acc, 4);
        a = s4[q + 3];
        x_group(kx4[q + 1], b, c, a, acc, partx);
      } else {
        x_group(kx4[q], a, b, c, acc, 4);
        a = s4[q + 3];
        x_group(kx4[q + 1], b, c, a, acc, 4);
        b = s4[q + 4];
        x_group(kx4[q + 2], c, a, b, acc, partx);
      }
      const int xo = x0 + kYxLane * (lane & 15);
      float* d = out + ((size_t)z * (unsigned)Y + (unsigned)gy) * (unsigned)X + xo;
      if ((X & 3) == 0 && xo + kYxLane <= X) {
        *reinterpret_cast<float4*>(d) = make_float4(acc[0], acc[1], acc[2], acc[3]);
        *reinterpret_cast<float4*>(d + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
      } else {
#pragma unroll
        for (int u = 0; u < kYxLane; ++u)
          if (xo + u < X) d[u] = acc[u];
      }
    }
    s_win += ty;
    if (s_win >= g.nring) s_win -= g.nring;
    s_new += ty;
    if (s_new >= g.nring) s_new -= g.nring;
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

bool taps_ok(int n) { return n >= 1 && n <= kMaxTaps && n % 2 == 1; }

// K4's launch (ops/conv.conv_yx_plan mirrors it): the tile height, its
// geometry, the y tiles a block walks (enough blocks for ~16 an SM, the
// walks evened out), grid and block, and whether it fits the card's
// limits.
struct YxLaunch {
  dim3 grid, block;
  YxGeom g;
  int tiles;
  bool ok;
};

YxLaunch conv_yx_launch(int Z, int Y, int X, int nky, int nkx, int size) {
  YxLaunch l{};
  for (int ty : kYxTileYs) {
    l.g = yx_geom(nky, nkx, size, ty);
    if (l.g.smem <= kSmemLimit / 4) break;
  }
  const int gx = (X + kYxTileX - 1) / kYxTileX, gy = (Y + l.g.ty - 1) / l.g.ty;
  const long long per = (long long)gx * gy * Z / kYxBlocks;
  l.tiles = (int)(per < 1 ? 1 : per > gy ? gy : per);
  const int groups = (gy + l.tiles - 1) / l.tiles;
  l.tiles = (gy + groups - 1) / groups;
  l.grid = dim3(gx, groups, Z);
  l.block = dim3(kYxThreads, 1, 1);
  l.ok = l.g.smem <= kSmemLimit && l.grid.y <= 65535 && l.grid.z <= 65535;
  return l;
}

// K4's shared memory limits, one per instance (the ring depends on the taps)
SmemLimit g_smem_limit_u8;
SmemLimit g_smem_limit_f32;

}  // namespace

extern "C" {

// K3: correlate a (Z, Y, X) uint8 (in_is_u8) or float32 volume along
// `axis` (0=z, 1=y, 2=x) with the `ntaps` (odd, <= 127) host taps,
// edge-replicated, into float32; `grad_border` doubles the end planes.
int pnr_conv1d_axis(const void* in, int in_is_u8, void* out, int Z, int Y, int X, int axis,
                    const float* taps, int ntaps, int grad_border, void* stream) {
  if (!taps_ok(ntaps) || axis < 0 || axis > 2)
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
  if (!taps_ok(nky) || !taps_ok(nkx)) return (int)cudaErrorInvalidValue;
  const YxLaunch l = conv_yx_launch(Z, Y, X, nky, nkx, in_is_u8 ? 1 : 4);
  if (!l.ok) return (int)cudaErrorInvalidValue;
  const Taps ty = load_taps(ky, nky), tx = load_taps(kx, nkx);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (in_is_u8) {
    err = raise_smem_limit(g_smem_limit_u8, conv_yx_kernel<unsigned char>, (size_t)l.g.smem);
    if (err != cudaSuccess) return (int)err;
    conv_yx_kernel<unsigned char><<<l.grid, l.block, l.g.smem, s>>>(
        (const unsigned char*)in, (float*)out, Y, X, l.g, l.tiles, ty, nky, tx, nkx);
  } else {
    err = raise_smem_limit(g_smem_limit_f32, conv_yx_kernel<float>, (size_t)l.g.smem);
    if (err != cudaSuccess) return (int)err;
    conv_yx_kernel<float><<<l.grid, l.block, l.g.smem, s>>>((const float*)in, (float*)out, Y, X,
                                                            l.g, l.tiles, ty, nky, tx, nkx);
  }
  return (int)cudaGetLastError();
}

// K4's launch for a (Z, Y, X) volume: out[0..11] = grid x, y, z, block x,
// y, z, dynamic shared bytes, tile height, tile width, y-pass run, y tiles
// a block walks and 1 if it fits. Returns cudaErrorInvalidValue for taps K4 does not take.
int pnr_conv_yx_plan(int Z, int Y, int X, int nky, int nkx, int in_is_u8, int* out) {
  if (!taps_ok(nky) || !taps_ok(nkx)) return (int)cudaErrorInvalidValue;
  const YxLaunch l = conv_yx_launch(Z, Y, X, nky, nkx, in_is_u8 ? 1 : 4);
  const int v[12] = {(int)l.grid.x, (int)l.grid.y, (int)l.grid.z, (int)l.block.x,
                     (int)l.block.y, (int)l.block.z, l.g.smem, l.g.ty, kYxTileX, kYxRun,
                     l.tiles, (int)l.ok};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
