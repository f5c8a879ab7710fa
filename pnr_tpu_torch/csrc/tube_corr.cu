// Tube-likelihood correlation for Hopper (sm_90a): `tube_corr`, one launch
// per likelihood evaluation of the tube tracer and of tube seed scoring.
//
// Replaces: the Pallas TPU kernels `_kernel` (launched by
// `hat_sample_pallas`, the tracer's per-window hat sampling) and
// `_fused_kernel` (launched by `hat_sample_fused`, sampling straight from
// the field, disabled on the TPU) in pnr_tpu/ops/pallas_sample.py, and the
// XLA glue around them in pnr_tpu/ops/zncc_fast.py (`_rel_coords`,
// `_finish`, `_corr_from_sums`). On the TPU the windows are cut out of the
// field into patches first (`extract`); here every query reads its
// trace's window in place in the packed field (S, Z, Y, 3X), element
// (s, z, y, 3x + c) holding channel c of sigma s at column x, as float32
// or bfloat16 (widened to float32 on load, exactly).
//
// Per query (t, n) and sigma s, for each line sample v with
// vmask[s, v] = 1 (the f32 math of the plain chain, ops/tube_corr.py):
//   q  = pos + vgrid[s, v] * dir                         (xyz)
//   r  = clamp(clamp(q, 0, dim - 1.001) - corner, 0, p - 1.001)  (zyx)
//   m_c += sum_{a,b,d} w_z(a) w_y(b) w_x(d) F[s, cz+z0+a, cy+y0+b, 3(cx+x0+d)+c]
// with (corner, p) the window of the sigma's group, z0 = floor(rz) clamped
// to [0, p - 2] and w(a) = max(0, 1 - |r - (z0+a)|); the z and y weights
// multiply first and the x weights last. Then the ZNCC of sigma s from the
// three sums (alpha scaling, the corrb clamp at 0, the denom > FLT_MIN
// gate with sqrt(max(denom, FLT_MIN))) and the max over the sigmas, the
// first maximum winning. The coordinate and correlation arithmetic uses
// explicitly rounded operations (__fmul_rn, __fadd_rn, ...) so that it is
// not contracted into fused multiply-adds: it rounds as the plain chain
// does, and a sample clamps where the plain chain clamps it.
//
// Layout: one warp per query. Its lanes take the query's S * NV
// (sigma, line sample) rows at once (27 rows at sigmas (2, 4, 6)), so the
// loads of all sigmas are in flight together, and leave the masked
// samples in shared memory; lane s then sums sigma s's line in sample
// order and computes its ZNCC, and lane 0 takes the max. Nothing but
// (corr, sig) is written (the (T, N, S, 3) sums only when asked for).
// Queries are numbered (t, n) with n fastest, so a block's four queries
// share a trace's windows and their cache lines in L1.
//
// What bounds it on the H100: not bytes or arithmetic. A tracer
// evaluation (T=128 traces x N=20 particles, three sigmas of up to nine
// samples) touches 2.6 MB of the field and does 6.8 MFLOP (chip_smoke.py's
// count, a bound under 1 us); its cost is one launch. The design therefore
// fuses what was ~200 small launches per tracer iteration (patch gathers,
// coordinates, sums, correlation) into one, and keeps the launch cheap:
// the model constants and the window table are a 1,504-byte struct copied
// to the card once per engine and volume shape and passed by pointer, so
// a launch costs the host about what a four-argument launch does
// (scripts/torch_tube_corr_host_cost.py); the launch is capture-safe: no
// host sync and no allocation. Windows are not staged in shared memory:
// the sigma-6 window (24, 32, 32) x 3 channels is 295 KB, over the 227 KB
// a block may hold, and a trace's rows touch a small part of it.
//
// The caller's corners are clamped again into the volume and, shifted by
// `origin`, into the field, and the tap corner into [0, p - 2], so a bad
// input can never read outside the field.
//
// A field may be a slab of the volume (a shard's, pnr_tpu_torch/parallel):
// `dims` are then the volume's, `fdims` the slab's and `origin` where the
// slab starts in the volume. Positions, corners and the clamps are the
// volume's; only the window's address is the slab's, so a query whose
// window lies in the slab reads what it reads in the whole field.
// Every window dimension must be >= 2 (the wrapper checks), but for a
// one-plane field (Z = 1, a 2-D stack): its windows have pz = 1, every
// sample's rz is 0 (JAX's `_rel_coords` at l == 1) and it weighs plane 0
// alone, reading nothing past it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxS = 8;
constexpr int kMaxNV = 16;
constexpr int kWarps = 4;  // queries per block, one warp each
constexpr int kThreads = 32 * kWarps;

// Mirrors `TubeParams` in pnr_tpu_torch/ops/tube_corr.py field for field
// (all 4-byte members, no padding); `pnr_tube_params_size` lets the
// wrapper check that the two agree. The kernel reads it from device memory.
struct TubeParams {
  int32_t S, NV, G;
  int32_t dims[3];              // volume (Z, Y, X)
  int32_t origin[3];            // the field's first element in the volume (zyx)
  int32_t fdims[3];             // the field's (Z, Y, X): dims, or a slab's
  int32_t group_of[kMaxS];      // sigma -> window group
  int32_t win[kMaxS][3];        // group window (pz, py, px)
  float win_hi[kMaxS][3];       // p - 1.001, rounded to float32
  float vol_hi[3];              // dim - 1.001, rounded to float32
  float flt_min;                // the plain chain's FLT_MIN gate, as float32
  float vgrid[kMaxS][kMaxNV];   // line sample offsets, zero-padded
  float vmask[kMaxS][kMaxNV];   // 1 where vgrid is a real sample
  float alpha1[kMaxS], alpha2[kMaxS], gbar[kMaxS], n[kMaxS], corrc[kMaxS], sigmas[kMaxS];
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

// bfloat16 is the top half of a float32: widening is a shift, exact
__device__ __forceinline__ float load(const uint16_t* p) {
  return __uint_as_float(((unsigned int)__ldg((const unsigned short*)p)) << 16);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int tap0(float r, int p) {
  return min(max((int)floorf(r), 0), p - 2);
}

__device__ __forceinline__ float hat(float r, int k) {
  return fmaxf(0.0f, 1.0f - fabsf(r - (float)k));
}

// Trilinear samples of the three channels at window coordinates (rz, ry,
// rx) in the window whose element (0, 0, 0) is at `w`; pitches in elements.
// A one-plane window (pz = 1) has one z tap, plane 0.
template <typename E>
__device__ __forceinline__ void sample3(const E* __restrict__ w, long long zpitch,
                                        long long ypitch, int pz, int py, int px, float rz,
                                        float ry, float rx, float out[3]) {
  const int nz = pz > 1 ? 2 : 1;
  const int z0 = pz > 1 ? tap0(rz, pz) : 0, y0 = tap0(ry, py), x0 = tap0(rx, px);
  const float wz[2] = {hat(rz, z0), hat(rz, z0 + 1)};
  const float wy[2] = {hat(ry, y0), hat(ry, y0 + 1)};
  const float wx0 = hat(rx, x0), wx1 = hat(rx, x0 + 1);
  float a0[3] = {0.0f, 0.0f, 0.0f};  // x tap 0, per channel
  float a1[3] = {0.0f, 0.0f, 0.0f};  // x tap 1
  const E* base = w + (long long)z0 * zpitch + (long long)y0 * ypitch + 3 * x0;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (a >= nz) break;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float wzy = wz[a] * wy[b];
      const E* p = base + a * zpitch + b * ypitch;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a0[c] += wzy * load(p + c);
        a1[c] += wzy * load(p + 3 + c);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = wx0 * a0[c] + wx1 * a1[c];
}

// field (S, FZ, FY, 3FX); corners (T, G, 3) int32 zyx; pos, dirs (T, N, 3)
// xyz; corr, sig (T, N); sums (T, N, S, 3) or null. One warp per query.
template <typename E>
__global__ void __launch_bounds__(kThreads)
    tube_corr_kernel(const E* __restrict__ field, const TubeParams* __restrict__ params,
                     const int* __restrict__ corners, const float* __restrict__ pos,
                     const float* __restrict__ dirs, long long queries, int N,
                     float* __restrict__ corr, float* __restrict__ sig,
                     float* __restrict__ sums) {
  __shared__ float line[kWarps][kMaxS * kMaxNV][3];  // masked samples per (s, v)
  __shared__ float zncc[kWarps][kMaxS];
  const TubeParams& p = *params;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long q = (long long)blockIdx.x * kWarps + w;
  if (q >= queries) return;  // the whole warp: only warp-level syncs below
  const long long t = q / N;
  const float ox = __ldg(pos + 3 * q), oy = __ldg(pos + 3 * q + 1), oz = __ldg(pos + 3 * q + 2);
  const float dx = __ldg(dirs + 3 * q), dy = __ldg(dirs + 3 * q + 1), dz = __ldg(dirs + 3 * q + 2);
  const int S = p.S, NV = p.NV;
  const int Z = p.dims[0], Y = p.dims[1], X = p.dims[2];
  const int FZ = p.fdims[0], FY = p.fdims[1], FX = p.fdims[2];
  const long long ypitch = 3LL * FX;
  const long long zpitch = (long long)FY * ypitch;
  const int* cq = corners + t * p.G * 3;
  // every (sigma, line sample) row of the query at once: its loads are in
  // flight together
  for (int r = lane; r < S * NV; r += 32) {
    const int s = r / NV, v = r - s * NV;
    const int g = p.group_of[s];
    const int pz = p.win[g][0], py = p.win[g][1], px = p.win[g][2];
    const int cz = min(max(__ldg(cq + 3 * g), 0), Z - pz);
    const int cy = min(max(__ldg(cq + 3 * g + 1), 0), Y - py);
    const int cx = min(max(__ldg(cq + 3 * g + 2), 0), X - px);
    const float vg = p.vgrid[s][v];
    const float qx = __fadd_rn(ox, __fmul_rn(vg, dx));
    const float qy = __fadd_rn(oy, __fmul_rn(vg, dy));
    const float qz = __fadd_rn(oz, __fmul_rn(vg, dz));
    const float rx = clampf(__fsub_rn(clampf(qx, 0.0f, p.vol_hi[2]), (float)cx), 0.0f,
                            p.win_hi[g][2]);
    const float ry = clampf(__fsub_rn(clampf(qy, 0.0f, p.vol_hi[1]), (float)cy), 0.0f,
                            p.win_hi[g][1]);
    const float rz = Z == 1 ? 0.0f
                            : clampf(__fsub_rn(clampf(qz, 0.0f, p.vol_hi[0]), (float)cz), 0.0f,
                                     p.win_hi[g][0]);
    // the window in the field: where the volume's window lies in it
    const int fz = min(max(cz - p.origin[0], 0), FZ - pz);
    const int fy = min(max(cy - p.origin[1], 0), FY - py);
    const int fx = min(max(cx - p.origin[2], 0), FX - px);
    const E* win = field + ((long long)s * FZ + fz) * zpitch + (long long)fy * ypitch + 3LL * fx;
    float m[3];
    sample3(win, zpitch, ypitch, pz, py, px, rz, ry, rx, m);
    const float mask = p.vmask[s][v];
#pragma unroll
    for (int c = 0; c < 3; ++c) line[w][r][c] = __fmul_rn(m[c], mask);
  }
  __syncwarp();
  if (lane < S) {
    // lane s: the three sums over the line in sample order, then the ZNCC
    // of sigma s (corr_from_sums)
    const int s = lane;
    float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f;
    for (int v = 0; v < NV; ++v) {
      m0 = __fadd_rn(m0, line[w][s * NV + v][0]);
      m1 = __fadd_rn(m1, line[w][s * NV + v][1]);
      m2 = __fadd_rn(m2, line[w][s * NV + v][2]);
    }
    const float s1 = __fmul_rn(m0, p.alpha1[s]);
    const float s2 = __fmul_rn(m1, p.alpha2[s]);
    const float s3 = __fmul_rn(m2, p.alpha2[s]);
    const float corra = __fsub_rn(s1, __fmul_rn(p.gbar[s], s2));
    const float corrb = fmaxf(__fsub_rn(s3, __fdiv_rn(__fmul_rn(s2, s2), p.n[s])), 0.0f);
    const float denom = __fmul_rn(corrb, p.corrc[s]);
    zncc[w][s] = denom > p.flt_min ? __fdiv_rn(corra, __fsqrt_rn(fmaxf(denom, p.flt_min)))
                                   : 0.0f;
    if (sums != nullptr) {
      float* o = sums + (q * S + s) * 3;
      o[0] = m0;
      o[1] = m1;
      o[2] = m2;
    }
  }
  __syncwarp();
  if (lane == 0) {
    // the max over the sigmas, the first maximum winning (torch.argmax)
    float best = zncc[w][0];
    int bs = 0;
    for (int s = 1; s < S; ++s) {
      if (zncc[w][s] > best) {
        best = zncc[w][s];
        bs = s;
      }
    }
    corr[q] = best;
    sig[q] = p.sigmas[bs];
  }
}

}  // namespace

extern "C" {

int pnr_tube_params_size() { return (int)sizeof(TubeParams); }

// field: float32 (bf16 = 0) or bfloat16 (bf16 = 1) (S, Z, Y, 3X); params: a
// TubeParams in device memory; corners: int32 (T, G, 3); pos,
// dirs: float32 (T, N, 3); corr, sig: float32 (T, N); sums: float32
// (T, N, S, 3) or null.
int pnr_tube_corr(const void* field, int bf16, const void* params, const void* corners,
                  const void* pos, const void* dirs, int T, int N, void* corr, void* sig,
                  void* sums, void* stream) {
  const long long queries = (long long)T * N;
  if (queries == 0) return 0;
  const TubeParams* p = (const TubeParams*)params;
  const unsigned int blocks = (unsigned int)((queries + kWarps - 1) / kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    tube_corr_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
        (const uint16_t*)field, p, (const int*)corners, (const float*)pos, (const float*)dirs,
        queries, N, (float*)corr, (float*)sig, (float*)sums);
  } else {
    tube_corr_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)field, p, (const int*)corners, (const float*)pos, (const float*)dirs,
        queries, N, (float*)corr, (float*)sig, (float*)sums);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
