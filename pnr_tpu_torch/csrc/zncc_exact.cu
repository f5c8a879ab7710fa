// Exact template ZNCC sums for Hopper (sm_90a): one thread-block cluster
// per trace, the trace's uint8 patch in shared memory.
//
// Replaces: the Pallas TPU kernel `_exact_kernel` launched by
// `_exact_sums_pallas` in pnr_tpu/ops/zncc_exact.py. That kernel keeps a
// trace's patch resident in VMEM across all of the trace's particles (grid
// (T, B), the patch block indexed by t alone) and contracts z-sorted
// template blocks against it on the MXU. This kernel keeps the same idea
// in the card's terms: the patch lives in shared memory, loaded once per
// launch, and every query of the trace reads it from there.
//
// What it computes (the f32 math of `_exact_sums_xla`, the specification
// being `exact_sums_plain` in ops/zncc_exact.py): for each (trace t,
// query b, sigma s) the sums A = sum(I - m0), B = sum((I - m0)^2),
// C = sum((I - m0) * g) over the sigma's template rows (v, u, w, g). A row's
// patch-frame coordinate comes from the 16 `qinfo` columns, is clamped to
// [0, hi], floored, and the uint8 patch is sampled trilinearly there.
// Output (T, B, S, 4) rows [A, B, C, 0], float32, no fast math.
//
// What bounded the design it replaces: one block per (trace, query), every
// template row doing 8 scattered byte loads straight from device memory. A
// warp's 32 rows lie along a ~36-voxel oriented line, so each load touched
// close to 32 sectors: the kernel was bound by L1 wavefronts of byte
// gathers (27x its operation bound), while each trace's ~400 KB patch was
// gathered about five times over by its 21 queries.
//
// The design here:
// * Slabs. The host (`slab_plan`) cuts the patch's pz planes into `nslab`
//   z slabs. Slab i owns the sample floors z1 in [i*step, min((i+1)*step,
//   pz-1)) and holds those planes plus the next one, because a sample reads
//   planes z1 and z1+1 and `qinfo` clamps rz to pz - 1.001. A slab fits one
//   block's shared memory (at sigmas (2,4,6), step 2: (56, 88, 82) u8, two
//   slabs of 29 planes, 225 KB each at an 88-byte row pitch; at sigmas
//   (2,3) the whole patch, 117 KB).
// * One plane. A 2-D stack's patch has pz = 1 and `qinfo` pins rz to 0:
//   the plan is one slab of that one plane (step 0) and a cluster of one
//   block; a sample is the bilinear value of the plane (JAX's `trilinear`
//   at l == 1), and no plane past it is loaded or read.
// * Clusters. Trace t is one cluster of min(nslab, 8) blocks on
//   neighbouring SMs; block r loads slabs r, r+8, ... one at a time. The
//   rows of a stack of any width X start at any byte, so TMA's 16-byte
//   strides and 16-byte `cp.async` do not fit. A shared-memory row holds
//   the global bytes from the aligned word at or below its first byte,
//   and a sample finds its row's first byte at the row's lead (the address
//   mod 4, which moves by X mod 4 per row and Y*X mod 4 per plane). The
//   rows are copied in aligned 16-byte loads, four in flight per thread,
//   each stored as the 4-byte words its row keeps (one 4-byte `cp.async`
//   per word would issue four times the load instructions). Every query of
//   the trace in this launch (20 particles, or the one estimate or seed)
//   reads the slab from there; the queries' 16 columns are staged next to
//   it.
// * Work. The block's 16 warps stride over a sigma's template rows, which
//   the host sorts by (w, v, u) so a warp's lanes share one (v, w) and so
//   one z plane; each row is loaded once for four queries, the next row's
//   load in flight while this one is sampled. Each block computes every
//   row's z, and only the block owning its floor samples it.
// * Reduction, deterministic and without atomics. Per (query, sigma) the
//   lanes reduce with a warp-shuffle tree and the warps in index order
//   through shared memory; block 0 of the cluster then adds the blocks'
//   partials in rank order through distributed shared memory and writes
//   the output. Two launches on the same inputs are bitwise equal.
//
// What bounds it now: shared-memory bank throughput of the byte reads (8 per
// sample per query) and the instructions around them, with one 16-warp
// block per SM to hide their latency; then the slab loads (each block
// reads its slab once from L2 or device memory) and, at B = 20, the 15
// (sigma, query group) reductions. Clusters, rather than a second launch
// over a scratch of per-slab partials, keep the in-order reduction in one
// launch and on chip.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// queries evaluated per template-row load
constexpr int kQG = 4;
// 16-byte loads each thread keeps in flight while a slab loads
constexpr int kLoads = 4;
// the portable cluster size
constexpr int kMaxCluster = 8;
// shared memory of the warps' partial sums: two buffers of
// (kQG, kWarps, 3) floats (ops/zncc_exact.py: _RED_BYTES)
constexpr int kRedFloats = 2 * kQG * kWarps * 3;
// a block's most dynamic shared memory on sm_90
constexpr size_t kMaxSmem = 232448;
// returned when the cluster cannot be scheduled on the card
constexpr int kErrUnschedulable = -2;
// returned when the shared memory or pitch the caller planned is wrong
constexpr int kErrPlan = -3;

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

__host__ __device__ __forceinline__ size_t round16(size_t n) { return (n + 15) & ~size_t(15); }

// The 4-byte word at the 4-aligned address `w`, its bytes outside the
// volume [vol, vol + total) read as 0.
__device__ __forceinline__ uint32_t load_word(const unsigned char* w, const unsigned char* vol,
                                              long long total) {
  uint32_t v = 0;
  for (int j = 0; j < 4; ++j)
    if (w + j >= vol && w + j < vol + total) v |= (uint32_t)__ldg(w + j) << (8 * j);
  return v;
}

// The 16 bytes at the 16-aligned address `c`: one load where the whole
// slab lies inside the volume, else word by word with zeros outside it.
__device__ __forceinline__ uint4 load_chunk(const unsigned char* c, const unsigned char* vol,
                                            long long total, bool inside) {
  if (inside) return __ldg(reinterpret_cast<const uint4*>(c));
  return make_uint4(load_word(c, vol, total), load_word(c + 4, vol, total),
                    load_word(c + 8, vol, total), load_word(c + 12, vol, total));
}

// Copy `nplanes` planes of py rows from `origin` (strides `plane` and X)
// into shared memory rows of `pitch` bytes. Row r holds the global bytes
// from the aligned word at or below its first byte, so that its patch
// bytes start at the row's lead (its first byte's address mod 4). The
// block's threads take the (row, 16-byte chunk) pairs in turn, kLoads at a
// time: the loads first, then each chunk's words that fall in its row.
// The caller synchronises.
__device__ void load_slab(unsigned char* slab, int pitch, const unsigned char* vol, long long total,
                          const unsigned char* origin, long long plane, int X, int nplanes, int py) {
  const int words = pitch >> 2;
  // the aligned chunks from the row's first byte to its last word
  const int nch = (pitch + 11) / 16 + 1;
  const int n = nplanes * py * nch;
  const uintptr_t last_row =
      reinterpret_cast<uintptr_t>(origin + (nplanes - 1) * plane + (long long)(py - 1) * X);
  const bool inside =
      (reinterpret_cast<uintptr_t>(origin) & ~uintptr_t(15)) >= reinterpret_cast<uintptr_t>(vol) &&
      (((last_row & ~uintptr_t(3)) + pitch - 1) & ~uintptr_t(15)) + 16 <=
          reinterpret_cast<uintptr_t>(vol + total);
  // this thread's (plane z, row y, chunk c), advanced by kThreads pairs a step
  int c = threadIdx.x % nch, y = threadIdx.x / nch;
  int z = y / py;
  y -= z * py;
  const int dy = kThreads / nch, dc = kThreads % nch;
  for (int base = 0; base < n; base += kThreads * kLoads) {
    uint4 v[kLoads];
    int row[kLoads], off[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      row[u] = -1;
      off[u] = 0;
      if (base + threadIdx.x + u * kThreads < n) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(origin + z * plane + (long long)y * X);
        const uintptr_t w0 = a & ~uintptr_t(3);
        const uintptr_t ch = (a & ~uintptr_t(15)) + 16 * c;
        if (ch < w0 + pitch) {
          row[u] = z * py + y;
          off[u] = (int)((long long)ch - (long long)w0) >> 2;  // from -3 words
          v[u] = load_chunk(reinterpret_cast<const unsigned char*>(ch), vol, total, inside);
        }
      }
      c += dc;
      y += dy;
      if (c >= nch) {
        c -= nch;
        ++y;
      }
      while (y >= py) {
        y -= py;
        ++z;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (row[u] < 0) continue;
      uint32_t* d = reinterpret_cast<uint32_t*>(slab + (size_t)row[u] * pitch);
      const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (off[u] + i >= 0 && off[u] + i < words) d[off[u] + i] = w[i];
    }
  }
}

// An integer-valued float in [0, 2^23) as an int, and a byte as a float,
// by the float's bits (two full-rate operations instead of one
// quarter-rate conversion).
__device__ __forceinline__ int float_to_index(float f) {
  return __float_as_int(f + 8388608.0f) - 0x4B000000;
}
__device__ __forceinline__ float byte_to_float(unsigned char b) {
  return __int_as_float(0x4B000000 | b) - 8388608.0f;
}

__global__ void __launch_bounds__(kThreads, 1)
exact_sums_kernel(const unsigned char* __restrict__ vol, int Z, int Y, int X,
                  const int* __restrict__ corner, const float* __restrict__ qs, int B,
                  const float4* __restrict__ tab, const int* __restrict__ cnt, int S, int Kmax,
                  int pz, int py, int px, int nslab, int step, int pitch, int ncl,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* slab = smem;
  float* red = reinterpret_cast<float*>(smem + round16((size_t)(step + 1) * py * pitch));
  float* part = red + kRedFloats;  // (B, S, 3) this block's partial sums
  float* qt = part + 3 * B * S;    // (B, 16) the trace's query columns

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = blockIdx.x / ncl;
  for (int i = threadIdx.x; i < B * Q_COLS; i += kThreads)
    qt[i] = __ldg(qs + (long long)t * B * Q_COLS + i);
  const long long plane = (long long)Y * X;
  const long long total = plane * Z;
  const unsigned char* pbase = vol + (long long)__ldg(corner + 3 * t) * plane +
                               (long long)__ldg(corner + 3 * t + 1) * X + __ldg(corner + 3 * t + 2);
  const int splane = py * pitch;
  // a row's lead (the first patch byte's offset in its shared-memory row)
  // is that of the slab's first row plus these per plane and per y row
  const int lead_z = (int)(plane & 3), lead_y = X & 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ngroups = (B + kQG - 1) / kQG;
  // a one-plane patch: one slab of one plane that owns floor 0
  const bool flat = pz == 1;
  int iter = 0;

  for (int sl = rank; sl < nslab; sl += ncl) {
    const int z0 = sl * step;
    const int zend = flat ? 1 : min(z0 + step, pz - 1);  // owned floors [z0, zend)
    const float z0f = (float)z0, zendf = (float)zend;
    const unsigned char* origin = pbase + z0 * plane;
    const int lead0 = (int)(reinterpret_cast<uintptr_t>(origin) & 3);
    __syncthreads();  // the previous slab's readers are done
    load_slab(slab, pitch, vol, total, origin, plane, X, flat ? 1 : zend - z0 + 1, py);
    __syncthreads();

    for (int s = 0; s < S; ++s) {
      const int k_n = __ldg(cnt + s);
      const float4* row = tab + (long long)s * Kmax;
      for (int g = 0; g < ngroups; ++g) {
        const int b0 = g * kQG;
        const int nq = min(kQG, B - b0);
        float rzp[kQG], ndz[kQG], wz[kQG], ryp[kQG], ndy[kQG], wy[kQG], rxp[kQG], ndx[kQG],
            wx[kQG], uy[kQG], ux[kQG], m0[kQG], zhi[kQG], yhi[kQG], xhi[kQG];
        float acc[kQG][3];
#pragma unroll
        for (int q = 0; q < kQG; ++q) {
          const float* p = qt + (b0 + (q < nq ? q : 0)) * Q_COLS;
          rzp[q] = p[Q_RZ]; ndz[q] = p[Q_NDZ]; wz[q] = p[Q_WZ];
          ryp[q] = p[Q_RY]; ndy[q] = p[Q_NDY]; wy[q] = p[Q_WY];
          rxp[q] = p[Q_RX]; ndx[q] = p[Q_NDX]; wx[q] = p[Q_WX];
          uy[q] = p[Q_UY]; ux[q] = p[Q_UX];
          m0[q] = p[Q_M0];
          zhi[q] = p[Q_ZHI]; yhi[q] = p[Q_YHI]; xhi[q] = p[Q_XHI];
          acc[q][0] = acc[q][1] = acc[q][2] = 0.0f;
        }
        int k = threadIdx.x;
        float4 next = k < k_n ? __ldg(row + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (; k < k_n; k += kThreads) {
          const float4 e = next;  // (v, u, w, g)
          if (k + kThreads < k_n) next = __ldg(row + k + kThreads);
#pragma unroll
          for (int q = 0; q < kQG; ++q) {
            if (q >= nq) break;
            const float rz = fminf(fmaxf(rzp[q] + e.x * ndz[q] + e.z * wz[q], 0.0f), zhi[q]);
            const float z1f = floorf(rz);
            if (z1f < z0f || z1f >= zendf) continue;  // another slab's sample
            const float ry =
                fminf(fmaxf(ryp[q] + e.x * ndy[q] + e.y * uy[q] + e.z * wy[q], 0.0f), yhi[q]);
            const float rx =
                fminf(fmaxf(rxp[q] + e.x * ndx[q] + e.y * ux[q] + e.z * wx[q], 0.0f), xhi[q]);
            const float y1f = floorf(ry), x1f = floorf(rx);
            const float zf = rz - z1f, yf = ry - y1f, xf = rx - x1f;
            const int dz = float_to_index(z1f - z0f), yi = float_to_index(y1f);
            // the four rows' leads: (z, y), (z, y+1), (z+1, y), (z+1, y+1)
            const int l00 = (lead0 + dz * lead_z + yi * lead_y) & 3;
            const int l01 = (l00 + lead_y) & 3, l10 = (l00 + lead_z) & 3;
            const int l11 = (l10 + lead_y) & 3;
            const unsigned char* p = slab + dz * splane + yi * pitch + float_to_index(x1f);
            const float r11a = byte_to_float(p[l00]), r11b = byte_to_float(p[l00 + 1]);
            const float r21a = byte_to_float(p[pitch + l01]);
            const float r21b = byte_to_float(p[pitch + l01 + 1]);
            const float plane1 = (1.0f - yf) * ((1.0f - xf) * r11a + xf * r11b) +
                                 yf * ((1.0f - xf) * r21a + xf * r21b);
            float val;
            if (flat) {
              val = plane1 - m0[q];
            } else {
              const float r12a = byte_to_float(p[splane + l10]);
              const float r12b = byte_to_float(p[splane + l10 + 1]);
              const float r22a = byte_to_float(p[splane + pitch + l11]);
              const float r22b = byte_to_float(p[splane + pitch + l11 + 1]);
              const float plane2 = (1.0f - yf) * ((1.0f - xf) * r12a + xf * r12b) +
                                   yf * ((1.0f - xf) * r22a + xf * r22b);
              val = ((1.0f - zf) * plane1 + zf * plane2) - m0[q];
            }
            acc[q][0] += val;
            acc[q][1] += val * val;
            acc[q][2] += val * e.w;
          }
        }
        // lanes by a shuffle tree, then the warps in index order; the two
        // buffers let one barrier per group separate writers and readers
        float* rb = red + (iter & 1) * (kQG * kWarps * 3);
#pragma unroll
        for (int q = 0; q < kQG; ++q)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float v = warp_sum(acc[q][c]);
            if (lane == 0) rb[(q * kWarps + warp) * 3 + c] = v;
          }
        __syncthreads();
        if (threadIdx.x < nq * 3) {
          const int q = threadIdx.x / 3, c = threadIdx.x - q * 3;
          float v = 0.0f;
          for (int w = 0; w < kWarps; ++w) v += rb[(q * kWarps + w) * 3 + c];
          float* dst = part + ((b0 + q) * S + s) * 3 + c;
          *dst = sl == rank ? v : *dst + v;
        }
        ++iter;
      }
    }
  }

  // block 0 adds the blocks' partials in rank order
  cluster.sync();
  if (rank == 0) {
    const int n = B * S * 3;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      float v = part[i];
      for (int r = 1; r < ncl; ++r) v += cluster.map_shared_rank(part, r)[i];
      const int pair = i / 3, c = i - pair * 3;
      float* o = out + ((long long)t * B * S + pair) * 4;
      o[c] = v;
      if (c == 2) o[3] = 0.0f;
    }
  }
  cluster.sync();  // the other blocks' shared memory lives until block 0 has read it
}

// The kernel's shared memory limit, and the (cluster size, shared memory)
// pairs already found schedulable per device, read and written under
// g_ok_mu: seed scoring (B=1) and the tracer (B=20) may launch K2 from two
// host threads at once.
SmemLimit g_smem_limit;
constexpr int kMaxDevices = kSmemLimitDevices;
constexpr int kCache = 8;
std::mutex g_ok_mu;
int g_ok_ncl[kMaxDevices][kCache];
size_t g_ok_smem[kMaxDevices][kCache];
int g_ok_n[kMaxDevices];

// The dynamic shared memory of one block: the slab (step + 1 planes of
// py rows of `pitch` bytes), the warps' partials, the (B, S, 3) sums and
// the (B, 16) query columns (ops/zncc_exact.py: smem_bytes).
size_t smem_bytes(int py, int pitch, int step, int B, int S) {
  return round16((size_t)(step + 1) * py * pitch) + sizeof(float) * kRedFloats +
         sizeof(float) * 3 * (size_t)B * S + sizeof(float) * Q_COLS * (size_t)B;
}

// Make a launch with `smem` bytes a block in clusters of `ncl` blocks
// possible on the current device `dev`: raise the kernel's shared memory
// limit, and check once per (ncl, smem) that such a cluster can be
// scheduled. Launches call it; so does pnr_exact_sums_prepare, ahead of a
// CUDA graph capture, which must not find this state missing.
int prepare_launch(int dev, size_t smem, int ncl) {
  cudaError_t err = raise_smem_limit(g_smem_limit, exact_sums_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(g_ok_mu);
  for (int i = 0; i < g_ok_n[dev]; ++i)
    if (g_ok_ncl[dev][i] == ncl && g_ok_smem[dev][i] == smem) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)ncl);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, exact_sums_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return kErrUnschedulable;
  const int i = g_ok_n[dev] < kCache ? g_ok_n[dev]++ : kCache - 1;
  g_ok_ncl[dev][i] = ncl;
  g_ok_smem[dev][i] = smem;
  return 0;
}

// The plan's checks of pnr_exact_sums: 0, or kErrPlan.
int check_plan(int pz, int py, int px, int nslab, int step, int pitch) {
  if (py < 2 || px < 2 || pitch < px + 3 || pitch % 4 != 0) return kErrPlan;
  if (pz == 1 ? (nslab != 1 || step != 0)
              : (pz < 2 || nslab < 1 || step < 1 || (long long)(nslab - 1) * step >= pz - 1 ||
                 (long long)nslab * step < pz - 1))
    return kErrPlan;
  return 0;
}

}  // namespace

extern "C" {

// pnr_exact_sums's launch state for a plan (its arguments as there) on the
// current device, set up without launching: see prepare_launch.
int pnr_exact_sums_prepare(int B, int S, int pz, int py, int px, int nslab, int step,
                           int pitch) {
  if (check_plan(pz, py, px, nslab, step, pitch)) return kErrPlan;
  const size_t smem = smem_bytes(py, pitch, step, B, S);
  if (smem > kMaxSmem) return kErrPlan;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return kErrPlan;
  return prepare_launch(dev, smem, nslab < kMaxCluster ? nslab : kMaxCluster);
}

// vol: uint8 (Z, Y, X); corner: int32 (T, 3) zyx, each patch inside vol;
// qs: float32 (T, B, 16); tab: float32 (S, Kmax, 4) rows (v, u, w, g);
// cnt: int32 (S,); patch (pz, py, px), py and px >= 2, cut into nslab
// slabs of `step` owned floors (pz >= 2), or pz = 1 with one slab of step
// 0 (a 2-D stack); rows of `pitch` bytes in shared memory; out: float32
// (T, B, S, 4).
int pnr_exact_sums(const void* vol, int Z, int Y, int X, const void* corner, const void* qs,
                   int T, int B, const void* tab, const void* cnt, int S, int Kmax, int pz, int py,
                   int px, int nslab, int step, int pitch, void* out, void* stream) {
  if (T == 0 || B == 0) return 0;
  if (check_plan(pz, py, px, nslab, step, pitch)) return kErrPlan;
  const size_t smem = smem_bytes(py, pitch, step, B, S);
  if (smem > kMaxSmem) return kErrPlan;
  const int ncl = nslab < kMaxCluster ? nslab : kMaxCluster;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return kErrPlan;
  const int ready = prepare_launch(dev, smem, ncl);
  if (ready) return ready;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)(ncl * T));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, exact_sums_kernel, (const unsigned char*)vol, Z, Y, X,
                           (const int*)corner, (const float*)qs, B, (const float4*)tab,
                           (const int*)cnt, S, Kmax, pz, py, px, nslab, step, pitch, ncl,
                           (float*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
