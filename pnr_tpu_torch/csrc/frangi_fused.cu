// Multi-scale 3-D Frangi vesselness for Hopper (sm_90a): K1.
//
// Replaces: the Pallas TPU kernel `_kernel` built by
// `_frangi3d_fused_impl` in pnr_tpu/ops/frangi_fused.py (one read of the
// uint8 stack; smoothing, Hessian, eigensolve and merge kept on chip in
// VMEM plane rings). This file keeps that idea with Hopper's tiles: one
// launch per sigma, one block of 1,024 threads per (y tile, x tile)
// column of the stack, walking z. Per plane the block
//   1. copies the uint8 plane's window (the tile plus an xy halo of
//      hxy + 2, edge-clamped) into shared memory with 16-byte `cp.async`
//      from the aligned chunk at or below each row's first byte (rows of a
//      stack of any width start at any byte; a row's bytes start at its
//      lead, the address mod 16), the next plane's copy in flight while
//      this one is computed;
//   2. runs the x pass, then the y pass of the Gaussian into a ring of the
//      last 2hz + 1 xy-smoothed planes G (each thread forms four outputs
//      from a sliding register window);
//   3. forms the z pass F[z] = sum_t kz[t] * G[clamp(z + t - hz)] into a
//      5-plane ring of F with an xy halo of 2;
//   4. from that ring, for the plane two behind, the six sigma^2-scaled
//      second derivatives with jnp.gradient's one-sided borders, the
//      closed-form eigensolve, the gated vesselness, the strict '>' merge
//      into J and the three uint8 directions, all in registers.
// Only J and the directions go to device memory; the smoothed volume and
// the Hessian never do. There is no float32 scratch volume.
//
// One launch per sigma, not the sigma loop in one launch: each sigma's
// halo sets its own tile (ops/frangi_fused.fused_plan takes the tile that
// finishes soonest among those whose rings fit a block's 232,448 bytes),
// and J must be merged across sigmas in device memory anyway, since a
// column's J does not fit on chip.
//
// Every output is computed as the three passes compute it: the x, y and z
// sums in tap order with fused multiply-adds, from 0, over edge-replicated
// reads, then the differences of ops/hessian.py in its order; the
// eigensolve differs in two roundings (see eig3_vessel). So K1 meets the
// plain chain's bars (frangi3d_plain) with a few ulps to spare per step.
//
// What bounds it on the H100 at (128, 640, 640), sigmas (2, 4, 6): by the
// repo's count, the operations: about 1,182 FLOPs per voxel (2 per
// Gaussian tap in the three passes, 18 for the differences, ~250 for the
// eigensolve, vesselness and merge per sigma), 0.925 ms at 67 TFLOP/s,
// against 8 B/voxel (u8 in, f32 J and three u8 directions out), 0.125 ms
// at 3.35 TB/s. In instructions the eigensolve is far dearer than 250
// FLOPs (IEEE divisions, square roots, acosf and sincosf, the selects and
// the addressing): the Hessian phase sets the time at every sigma. The
// halo costs extra pass work: at sigma 6 (hxy = 18) a 40 x 40 tile runs
// the x pass on 80 x 44 positions and the y and z passes on 44 x 44 for
// 40 x 40 outputs, 2.2x, 1.21x and 1.21x the passes' own work. The design
// takes 40 x 40 tiles at this stack (256 blocks: two rounds on 132 SMs,
// where 32 x 32 takes four), reuses each shared-memory read four times in
// registers in the x and y passes, computes each G plane once (the ring
// holds the z halo), and runs 32 warps a block to hide the eigensolve's
// latency.
//
// Index arithmetic: each block forms its 64-bit plane and row bases once
// per plane from blockIdx and the strides; per voxel it uses 32-bit
// offsets, with no 64-bit division or remainder.
//
// Numerics follow pnr_tpu/ops/frangi.py: IEEE expf/sqrtf/acosf/sincosf
// (no fast math), half-to-even quantisation (rintf), NaN -> 0, strict '>'
// merge.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kRun = 4;          // outputs per thread in the x and y passes
constexpr int kFRing = 5;        // planes of F the Hessian reads
constexpr int kMaxTapsXY = 127;  // hxy <= 63: sigma <= 21
constexpr int kMaxTapsZ = 255;   // hz <= 127
constexpr int kSmemLimit = 232448;
constexpr float kEps = 1e-20f;
constexpr float kSqrt3Over2 = 0.8660254037844386f;

struct FrangiTaps {
  float xy[kMaxTapsXY];
  float z[kMaxTapsZ];
};

// The block's geometry, from the tile and the sigma's half-widths.
struct Geom {
  int TY, TX, hxy, hz;
  __host__ __device__ int h2() const { return hxy + 2; }
  __host__ __device__ int WY() const { return TY + 2 * h2(); }  // u8 window rows
  __host__ __device__ int WX() const { return TX + 2 * h2(); }  // u8 window columns
  __host__ __device__ int CH() const { return TY + 4; }         // G/F rows (halo 2)
  __host__ __device__ int CW() const { return TX + 4; }         // G/F columns (halo 2)
  // u8 row pitch: the lead (< 16), the window and the 4 bytes the x pass's
  // last group of taps reads beyond it
  __host__ __device__ int P() const { return (WX() + 19 + 15) & ~15; }
  __host__ __device__ int D() const { return 2 * hz + 1; }      // G ring depth
  // dynamic shared memory: x-pass rows, G ring, F ring, two u8 planes, the
  // z pass's slot offsets and the block reduction's warp partials
  // (ops/frangi_fused.smem_bytes)
  __host__ __device__ int smem() const {
    return 4 * (WY() * CW() + (D() + kFRing) * CH() * CW()) + 2 * WY() * P() +
           16 * ((D() + 3) / 4) + 2 * (kThreads / 32) * 4;
  }
};

__device__ __forceinline__ unsigned int float_to_ordered(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ordered_to_float(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Start copying plane z's window into `buf`: row r holds the bytes of
// global row clamp(y0 - h2 + r) from the 16-byte chunk at or below its
// first in-volume byte gxa; the copy stays inside the chunks that hold
// bytes gxa..gxb, so it never reads past the volume's last chunk.
__device__ __forceinline__ void load_plane(unsigned char* buf, const unsigned char* vol,
                                           long long plane_off, const Geom& g, int Y, int X,
                                           int y0, int gxa, int len) {
  const int pitch = g.P(), maxch = pitch >> 4, h2 = g.h2();
  const int n = g.WY() * maxch;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / maxch, c = i - r * maxch;
    const int gy = min(max(y0 - h2 + r, 0), Y - 1);
    const unsigned char* src = vol + plane_off + (long long)gy * X + gxa;
    const int lead = (int)(reinterpret_cast<uintptr_t>(src) & 15);
    if (c < ((lead + len + 15) >> 4))
      cp_async16(buf + r * pitch + 16 * c, src - lead + 16 * c);
  }
}

// A sliding correlation of kRun consecutive outputs, in tap order with
// fused multiply-adds from 0: out[u] = sum_t k[t] * in(c0 + t + u). The
// window e holds inputs c0 + g .. c0 + g + 7 while taps g .. g + 3 apply
// (it reads up to 4 inputs past the last one used).
template <typename In>
__device__ __forceinline__ void slide(const float* k, int nt, int c0, In in, float (&acc)[kRun]) {
  float e[2 * kRun];
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    acc[u] = 0.0f;
    e[u] = in(c0 + u);
  }
  for (int g = 0; g < nt; g += 4) {
#pragma unroll
    for (int u = 0; u < kRun; ++u) e[kRun + u] = in(c0 + g + kRun + u);
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      if (g + tt < nt) {
        const float kk = k[g + tt];
#pragma unroll
        for (int u = 0; u < kRun; ++u) acc[u] = fmaf(kk, e[tt + u], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRun; ++u) e[u] = e[kRun + u];
  }
}

// x pass of one plane: xs[r][c] = sum_t kxy[t] * u8(row r, x0 - 2 + c +
// t - hxy), the column edge-clamped (EDGE: the window leaves the volume
// in x) or read straight from the window (interior blocks).
template <bool EDGE>
__device__ __forceinline__ void x_pass(const unsigned char* buf, float* xs,
                                       const FrangiTaps& taps, const Geom& g, unsigned plane_lo,
                                       int Y, int X, int y0, int x0, int gxa) {
  const int CW = g.CW(), WY = g.WY(), pitch = g.P(), h2 = g.h2(), nt = 2 * g.hxy + 1;
  const int groups = CW / kRun;
  for (int i = threadIdx.x; i < WY * groups; i += kThreads) {
    const int r = i / groups;
    const int c0 = (i - r * groups) * kRun;
    const int gy = min(max(y0 - h2 + r, 0), Y - 1);
    const int lead = (int)((plane_lo + (unsigned)gy * (unsigned)X + (unsigned)gxa) & 15u);
    const unsigned char* row = buf + r * pitch + lead;
    float acc[kRun];
    if (EDGE)
      slide(taps.xy, nt, c0,
            [&](int j) { return (float)row[min(max(x0 - h2 + j, 0), X - 1) - gxa]; }, acc);
    else
      slide(taps.xy, nt, c0, [&](int j) { return (float)row[j]; }, acc);
    float* o = xs + r * CW + c0;
#pragma unroll
    for (int u = 0; u < kRun; ++u) o[u] = acc[u];
  }
}

// y pass: G[r][c] = sum_t kxy[t] * xs[r + t][c], four rows a thread (the
// window's reads past the last row land in the G ring, which follows xs).
__device__ __forceinline__ void y_pass(const float* xs, float* gp, const FrangiTaps& taps,
                                       const Geom& g) {
  const int CW = g.CW(), nt = 2 * g.hxy + 1;
  const int n = (g.CH() / kRun) * CW;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int grp = i / CW;
    const int c = i - grp * CW, r0 = grp * kRun;
    const float* col = xs + c;
    float acc[kRun];
    slide(taps.xy, nt, r0, [&](int j) { return col[j * CW]; }, acc);
#pragma unroll
    for (int u = 0; u < kRun; ++u) gp[(r0 + u) * CW + c] = acc[u];
  }
}

// z pass: F[zf] = sum_t kz[t] * G[clamp(zf + t - hz)], the G planes read
// from their ring slots (plane p in slot p mod D) through the step's
// table of slot offsets; two outputs a thread at a time.
__device__ __forceinline__ void z_pass(const float* gring, const int* zoff, float* fp,
                                       const FrangiTaps& taps, const Geom& g) {
  const int n = g.CH() * g.CW(), nt = 2 * g.hz + 1;
  for (int i = threadIdx.x; i < n; i += 2 * kThreads) {
    const int i1 = min(i + kThreads, n - 1);
    float a0 = 0.0f, a1 = 0.0f;
    for (int t = 0; t < nt; ++t) {
      const float* gp = gring + zoff[t];
      const float k = taps.z[t];
      a0 = fmaf(k, gp[i], a0);
      a1 = fmaf(k, gp[i1], a1);
    }
    fp[i] = a0;
    if (i + kThreads < n) fp[i1] = a1;
  }
}

// jnp.gradient's neighbours of position p on [0, n): the steps to the low
// and high sample and whether p is a border (one-sided: no halving).
struct Nb {
  int lo, hi;
  bool edge;
};

__device__ __forceinline__ Nb nb(int p, int n) {
  return {p == 0 ? 0 : -1, p == n - 1 ? 0 : 1, p == 0 || p == n - 1};
}

__device__ __forceinline__ float half_unless(bool edge, float d) { return edge ? d : d * 0.5f; }

// The F planes the Hessian of output plane zo reads, uniform over the
// block: zo, its neighbours zl, zh, and theirs (ops/hessian.py's order).
struct ZPlanes {
  const float *c, *l, *h, *ll, *lh, *hl, *hh;
  bool e, el, eh;
};

__device__ __forceinline__ ZPlanes z_planes(const float* fring, int n, int zo, int Z) {
  auto at = [&](int z) { return fring + (z % kFRing) * n; };
  const Nb a = nb(zo, Z);
  const int zl = zo + a.lo, zh = zo + a.hi;
  const Nb bl = nb(zl, Z), bh = nb(zh, Z);
  return {at(zo), at(zl), at(zh), at(zl + bl.lo), at(zl + bl.hi), at(zh + bh.lo),
          at(zh + bh.hi), a.edge, bl.edge, bh.edge};
}

__device__ __forceinline__ unsigned char quantize_dir(float v) {
  const float q = rintf(((v + 1.0f) / 2.0f) * 255.0f);
  return (unsigned char)fminf(fmaxf(q, 0.0f), 255.0f);
}

// Closed-form |lambda|-sorted eigensolve (pnr_tpu/ops/eig3.py), with two
// changes of rounding against the plain chain, each within an ulp or two:
// the divisions by 3, by 6 and by p are multiplications by reciprocals, and
// cos(phi + 2 pi / 3) is -cos(phi) / 2 - sin(phi) sqrt(3) / 2 from one
// sincosf. Straight-line code.
__device__ __forceinline__ void eig3_vessel(float a11, float a22, float a33, float a12,
                                            float a13, float a23, float& lam1, float& lam2,
                                            float& lam3, float& vx, float& vy, float& vz) {
  const float p1 = a12 * a12 + a13 * a13 + a23 * a23;
  const float q = (a11 + a22 + a33) * (1.0f / 3.0f);
  const float b11 = a11 - q, b22 = a22 - q, b33 = a33 - q;
  const float p2 = b11 * b11 + b22 * b22 + b33 * b33 + 2.0f * p1;
  const float p = sqrtf(fmaxf(p2 * (1.0f / 6.0f), 0.0f));
  const float ips = 1.0f / fmaxf(p, kEps);
  const float c11 = b11 * ips, c22 = b22 * ips, c33 = b33 * ips;
  const float c12 = a12 * ips, c13 = a13 * ips, c23 = a23 * ips;
  const float detb = c11 * (c22 * c33 - c23 * c23) - c12 * (c12 * c33 - c23 * c13) +
                     c13 * (c12 * c23 - c22 * c13);
  const float r = fminf(fmaxf(detb * 0.5f, -1.0f), 1.0f);
  const float phi = acosf(r) * (1.0f / 3.0f);
  float sn, cs;
  sincosf(phi, &sn, &cs);
  float e_hi = q + 2.0f * p * cs;
  float e_lo = q + 2.0f * p * (-0.5f * cs - kSqrt3Over2 * sn);
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
  float nb_ = use2 ? n2 : n1;
  const bool use3 = n3 > nb_;
  ux = use3 ? c3x : ux;
  uy = use3 ? c3y : uy;
  uz = use3 ? c3z : uz;
  nb_ = use3 ? n3 : nb_;
  const bool flat = nb_ <= kEps;
  const float inv = 1.0f / sqrtf(flat ? 1.0f : nb_);
  vx = flat ? 1.0f : ux * inv;
  vy = flat ? 0.0f : uy * inv;
  vz = flat ? 0.0f : uz * inv;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct ScaleArgs {
  float s2, a2, b2, c2;
  int blackwhite, first, last;
};

// The vesselness of one voxel of output plane zo (at in-plane offset o of
// the F ring, volume row y and column x) and its lambda-smallest
// eigenvector. The six second derivatives are ops/hessian.py's (gradient
// along b of gradient along a, jnp.gradient borders), each difference and
// halving in the order of the plain chain, then * sigma^2.
struct Vessel {
  float v, ex, ey, ez;
};

__device__ __forceinline__ Vessel vessel(const ZPlanes& zp, int CW, const ScaleArgs& sa, int Y,
                                         int X, int y, int x, int o) {
  const Nb by = nb(y, Y), bx = nb(x, X);
  const Nb byl = nb(y + by.lo, Y), byh = nb(y + by.hi, Y);
  const Nb bxl = nb(x + bx.lo, X), bxh = nb(x + bx.hi, X);
  const int yl = by.lo * CW, yh = by.hi * CW;
  // grad1 along y and along x of plane P at in-plane offset q
  auto g1y = [&](const float* P, int q) { return half_unless(by.edge, P[q + yh] - P[q + yl]); };
  auto g1x = [&](const float* P, int q) {
    return half_unless(bx.edge, P[q + bx.hi] - P[q + bx.lo]);
  };
  const float dzz = half_unless(zp.e, half_unless(zp.eh, zp.hh[o] - zp.hl[o]) -
                                          half_unless(zp.el, zp.lh[o] - zp.ll[o])) * sa.s2;
  const float dyy =
      half_unless(by.edge,
                  half_unless(byh.edge, zp.c[o + yh + byh.hi * CW] - zp.c[o + yh + byh.lo * CW]) -
                      half_unless(byl.edge, zp.c[o + yl + byl.hi * CW] -
                                                zp.c[o + yl + byl.lo * CW])) * sa.s2;
  const float dyz = half_unless(zp.e, g1y(zp.h, o) - g1y(zp.l, o)) * sa.s2;
  const float dxx =
      half_unless(bx.edge,
                  half_unless(bxh.edge, zp.c[o + bx.hi + bxh.hi] - zp.c[o + bx.hi + bxh.lo]) -
                      half_unless(bxl.edge, zp.c[o + bx.lo + bxl.hi] - zp.c[o + bx.lo + bxl.lo])) *
      sa.s2;
  const float dxy = half_unless(by.edge, g1x(zp.c, o + yh) - g1x(zp.c, o + yl)) * sa.s2;
  const float dxz = half_unless(zp.e, g1x(zp.h, o) - g1x(zp.l, o)) * sa.s2;
  Vessel r;
  float l1, l2, l3;
  eig3_vessel(dxx, dyy, dzz, dxy, dxz, dyz, l1, l2, l3, r.ex, r.ey, r.ez);
  const float aa1 = fabsf(l1), aa2 = fabsf(l2), aa3 = fabsf(l3);
  const float ra = aa2 / aa3;
  const float rb = aa1 / sqrtf(aa2 * aa3);
  const float s = sqrtf(aa1 * aa1 + aa2 * aa2 + aa3 * aa3);
  float v = (1.0f - expf(-(ra * ra) / sa.a2)) * expf(-(rb * rb) / sa.b2) *
            (1.0f - expf(-(s * s) / sa.c2));
  const bool gate = sa.blackwhite ? (l2 < 0.0f || l3 < 0.0f) : (l2 > 0.0f || l3 > 0.0f);
  if (gate) v = 0.0f;
  if (v != v) v = 0.0f;
  r.v = v;
  return r;
}

// The strict '>' merge of one voxel into J and the directions; vmin/vmax
// gather Jmin (first scale) and Jmax (last).
__device__ __forceinline__ void merge(const Vessel& r, const ScaleArgs& sa, long long i,
                                      float* __restrict__ J, unsigned char* __restrict__ qx,
                                      unsigned char* __restrict__ qy,
                                      unsigned char* __restrict__ qz, float& vmin, float& vmax) {
  float jv;
  if (sa.first || r.v > J[i]) {
    J[i] = r.v;
    qx[i] = quantize_dir(r.ex);
    qy[i] = quantize_dir(r.ey);
    qz[i] = quantize_dir(r.ez);
    jv = r.v;
  } else {
    jv = J[i];
  }
  if (sa.first) vmin = fminf(vmin, r.v);
  if (sa.last) vmax = fmaxf(vmax, jv);
}

// Output plane zo of the block's tile, one output a thread at a time,
// stepping through the tile's rows and columns by adding (no division).
// One straight-line body a voxel keeps the kernel's code small: two voxels
// a thread, or a second copy of the body for voxels away from the borders,
// each measured slower on the H100 (PERF.md, PR 6).
__device__ __forceinline__ void hessian_plane(const ZPlanes& zp, const Geom& g,
                                              const ScaleArgs& sa, long long plane_off, int Y,
                                              int X, int y0, int x0, float* __restrict__ J,
                                              unsigned char* __restrict__ qx,
                                              unsigned char* __restrict__ qy,
                                              unsigned char* __restrict__ qz, float& vmin,
                                              float& vmax) {
  const long long base = plane_off + (long long)y0 * X + x0;
  const int CW = g.CW(), TX = g.TX;
  const int dly = kThreads / TX, dlx = kThreads - dly * TX;
  int ly = threadIdx.x / TX, lx = threadIdx.x - ly * TX;
  while (ly < g.TY) {
    const int y = y0 + ly, x = x0 + lx;
    if (y < Y && x < X)
      merge(vessel(zp, CW, sa, Y, X, y, x, (ly + 2) * CW + lx + 2), sa, base + ly * X + lx, J,
            qx, qy, qz, vmin, vmax);
    ly += dly;
    lx += dlx;
    if (lx >= TX) {
      lx -= TX;
      ++ly;
    }
  }
}

// One sigma over the whole stack. Block (bx, by) owns the outputs
// [y0, y0 + TY) x [x0, x0 + TX) of every plane and walks z: at step k it
// smooths plane k in xy into the G ring (k < Z), forms F[k - hz], and
// finishes output plane k - hz - 2.
__global__ void __launch_bounds__(kThreads, 1)
frangi_fused_kernel(const unsigned char* __restrict__ vol, int Z, int Y, int X, Geom g,
                    const __grid_constant__ FrangiTaps taps, ScaleArgs sa,
                    float* __restrict__ J, unsigned char* __restrict__ qx,
                    unsigned char* __restrict__ qy, unsigned char* __restrict__ qz,
                    unsigned int* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int CHW = g.CH() * g.CW(), D = g.D();
  float* xs = reinterpret_cast<float*>(smem);
  float* gring = xs + g.WY() * g.CW();
  float* fring = gring + D * CHW;
  unsigned char* u8buf = reinterpret_cast<unsigned char*>(fring + kFRing * CHW);
  int* zoff = reinterpret_cast<int*>(u8buf + 2 * g.WY() * g.P());
  float* red = reinterpret_cast<float*>(zoff + 4 * ((D + 3) / 4));
  const int plane_bytes = g.WY() * g.P();

  const int y0 = blockIdx.y * g.TY, x0 = blockIdx.x * g.TX, h2 = g.h2();
  const int gxa = max(x0 - h2, 0), gxb = min(x0 + g.TX + h2 - 1, X - 1);
  const int len = gxb - gxa + 1;
  const bool xedge = x0 - h2 < 0 || x0 + g.TX + h2 > X;
  const long long YX = (long long)Y * X;
  const unsigned vol_lo = (unsigned)reinterpret_cast<uintptr_t>(vol);

  float vmin = __int_as_float(0x7f800000);  // +inf
  float vmax = __int_as_float(0xff800000);  // -inf
  load_plane(u8buf, vol, 0, g, Y, X, y0, gxa, len);
  cp_async_commit();
  const int steps = Z + g.hz + 2;
  for (int k = 0; k < steps; ++k) {
    const int zf = k - g.hz;
    // the z pass's slot offsets: G plane clamp(zf + t - hz) in slot p mod D
    if (zf >= 0 && zf < Z && (int)threadIdx.x < D)
      zoff[threadIdx.x] = (min(max(zf + (int)threadIdx.x - g.hz, 0), Z - 1) % D) * CHW;
    if (k < Z) {
      if (k + 1 < Z)
        load_plane(u8buf + ((k + 1) & 1) * plane_bytes, vol, (long long)(k + 1) * YX, g, Y, X,
                   y0, gxa, len);
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();
      const unsigned char* buf = u8buf + (k & 1) * plane_bytes;
      const unsigned plane_lo = vol_lo + (unsigned)((long long)k * YX);
      if (xedge)
        x_pass<true>(buf, xs, taps, g, plane_lo, Y, X, y0, x0, gxa);
      else
        x_pass<false>(buf, xs, taps, g, plane_lo, Y, X, y0, x0, gxa);
      __syncthreads();
      y_pass(xs, gring + (k % D) * CHW, taps, g);
    }
    __syncthreads();
    if (zf >= 0 && zf < Z) z_pass(gring, zoff, fring + (zf % kFRing) * CHW, taps, g);
    __syncthreads();
    const int zo = zf - 2;
    if (zo >= 0 && zo < Z)
      hessian_plane(z_planes(fring, CHW, zo, Z), g, sa, (long long)zo * YX, Y, X, y0, x0, J, qx,
                    qy, qz, vmin, vmax);
  }

  if (!sa.first && !sa.last) return;
  vmin = warp_min(vmin);
  vmax = warp_max(vmax);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp] = vmin;
    red[kThreads / 32 + warp] = vmax;
  }
  __syncthreads();
  if (warp == 0) {
    vmin = lane < kThreads / 32 ? red[lane] : __int_as_float(0x7f800000);
    vmax = lane < kThreads / 32 ? red[kThreads / 32 + lane] : __int_as_float(0xff800000);
    vmin = warp_min(vmin);
    vmax = warp_max(vmax);
    if (lane == 0) {
      if (sa.first) atomicMin(stats + 0, float_to_ordered(vmin));
      if (sa.last) atomicMax(stats + 1, float_to_ordered(vmax));
    }
  }
}

__global__ void decode_stats_kernel(const unsigned int* __restrict__ stats,
                                    float* __restrict__ out) {
  if (threadIdx.x == 0) {
    out[0] = ordered_to_float(stats[0]);
    out[1] = ordered_to_float(stats[1]);
  }
}

bool geom_ok(const Geom& g) {
  return g.TY >= kRun && g.TX >= kRun && g.TY % kRun == 0 && g.TX % kRun == 0 && g.hxy >= 0 &&
         g.hz >= 0 && 2 * g.hxy + 1 <= kMaxTapsXY && 2 * g.hz + 1 <= kMaxTapsZ &&
         2 * g.hz + 1 <= kThreads && g.smem() <= kSmemLimit;
}

// K1's shared memory limit (the tile's rings differ per sigma)
SmemLimit g_smem_limit;

}  // namespace

extern "C" {

// Dynamic shared memory of one K1 block at a (tile_y, tile_x) tile and the
// half-widths hxy, hz (the sum ops/frangi_fused.fused_plan computes).
int pnr_frangi_smem_bytes(int tile_y, int tile_x, int hxy, int hz) {
  return Geom{tile_y, tile_x, hxy, hz}.smem();
}

// One sigma of K1 over a (Z, Y, X) uint8 stack: the xy taps kxy (2 hxy + 1)
// and the z taps kz (2 hz + 1), host float32; the tile from fused_plan.
// `stats` is uint32[2] (ordered-int min, max), initialised by the caller
// to {0xffffffff, 0}; after the last scale `minmax` (float32[2]) receives
// (Jmin, Jmax). Returns cudaErrorInvalidValue if the tile, the taps or
// the shared memory do not fit.
int pnr_frangi_scale(const void* vol, int Z, int Y, int X, int tile_y, int tile_x,
                     const float* kxy, int nkxy, const float* kz, int nkz, float s2, float a2,
                     float b2, float c2, int blackwhite, int first, int last, void* J, void* qx,
                     void* qy, void* qz, void* stats, void* minmax, void* stream) {
  const Geom g{tile_y, tile_x, nkxy / 2, nkz / 2};
  if (nkxy % 2 == 0 || nkz % 2 == 0 || Z < 2 || Y < 2 || X < 2 || !geom_ok(g))
    return (int)cudaErrorInvalidValue;
  FrangiTaps taps = {};
  for (int i = 0; i < nkxy; ++i) taps.xy[i] = kxy[i];
  for (int i = 0; i < nkz; ++i) taps.z[i] = kz[i];
  const ScaleArgs sa{s2, a2, b2, c2, blackwhite, first, last};
  const dim3 grid((X + tile_x - 1) / tile_x, (Y + tile_y - 1) / tile_y, 1);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = raise_smem_limit(g_smem_limit, frangi_fused_kernel, (size_t)g.smem());
  if (err != cudaSuccess) return (int)err;
  frangi_fused_kernel<<<grid, kThreads, g.smem(), s>>>(
      (const unsigned char*)vol, Z, Y, X, g, taps, sa, (float*)J, (unsigned char*)qx,
      (unsigned char*)qy, (unsigned char*)qz, (unsigned int*)stats);
  err = cudaGetLastError();
  if (err != cudaSuccess || !last) return (int)err;
  decode_stats_kernel<<<1, 32, 0, s>>>((const unsigned int*)stats, (float*)minmax);
  return (int)cudaGetLastError();
}

}  // extern "C"
