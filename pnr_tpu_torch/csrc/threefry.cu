// The tracer's Threefry-2x32 uniforms for Hopper (sm_90a).
//
// Replaces: `_uniforms` of the JAX tracer's jitted stage
// (pnr_tpu/smc/tracker.py:327-329, called in `trace_init` and
// `trace_stage`): `vmap(fold_in(key, step))` then `vmap(uniform(key,
// shape))` under jax_threefry_partitionable, which XLA runs inside the
// stage. No Pallas kernel: JAX draws with `jax.random`. Bitwise
// `hostpath/threefry.uniforms_per_trace` (the NumPy port of
// jax._src.prng's `_threefry2x32_lowering`, `threefry_fold_in`,
// `_threefry_random_bits_partitionable` and `_uniform`).
//
// One launch draws a whole stage: for trace t and iteration i = it0 + j,
// u1[j, t, c] (c < np) is the c-th uniform of fold_in(key_t, 2i) and
// ru[j, t] the first uniform of fold_in(key_t, 2i + 1). `it0` is read from
// device memory, so a stage captured in a CUDA graph draws the iteration
// that its static `it0` buffer holds at each replay.
//
// What bounds it: a launch. One thread per (iteration, trace, draw) hashes
// twice (the fold and the counter), 20 rounds of add, rotate and xor each,
// so the fold of a (trace, step) is hashed once per draw: 2 (np + 1)
// hashes a trace and iteration where the function needs np + 3. A tube
// stage (16 x 128 x 21 threads) writes 172 KB and needs ~3.6 M integer
// operations (~73 a hash), microseconds of the card.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define PNR_TF_ROUNDS(a, b, c, d) \
  x0 += x1; x1 = rotl(x1, a) ^ x0; \
  x0 += x1; x1 = rotl(x1, b) ^ x0; \
  x0 += x1; x1 = rotl(x1, c) ^ x0; \
  x0 += x1; x1 = rotl(x1, d) ^ x0;

// Threefry-2x32, 20 rounds, on the counter (x0, x1) under the key (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  PNR_TF_ROUNDS(13, 15, 26, 6)
  x0 += k1;
  x1 += k2 + 1u;
  PNR_TF_ROUNDS(17, 29, 16, 24)
  x0 += k2;
  x1 += k0 + 2u;
  PNR_TF_ROUNDS(13, 15, 26, 6)
  x0 += k0;
  x1 += k1 + 3u;
  PNR_TF_ROUNDS(17, 29, 16, 24)
  x0 += k1;
  x1 += k2 + 4u;
  PNR_TF_ROUNDS(13, 15, 26, 6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef PNR_TF_ROUNDS

__global__ void threefry_uniforms_kernel(const uint32_t* __restrict__ keys,
                                         const int* __restrict__ it0, int t, int n_it,
                                         int npart, float* __restrict__ u1,
                                         float* __restrict__ ru) {
  const int draws = npart + 1;
  const long long total = (long long)n_it * t * draws;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % draws);
  const long long jt = idx / draws;
  const int tr = (int)(jt % t);
  const int j = (int)(jt / t);
  // the absolute iteration's step, as uint32 (jnp's int32 2i wraps alike)
  const uint32_t i = (uint32_t)it0[0] + (uint32_t)j;
  const bool res = c == npart;
  // fold_in(key, step): the hash of the counter (0, step)
  uint32_t f0 = 0u, f1 = 2u * i + (res ? 1u : 0u);
  threefry2x32(keys[2 * tr], keys[2 * tr + 1], f0, f1);
  // random bits of draw c: the hash of (0, c), halves xored
  uint32_t x0 = 0u, x1 = res ? 0u : (uint32_t)c;
  threefry2x32(f0, f1, x0, x1);
  const uint32_t bits = x0 ^ x1;
  const float u = fmaxf(0.0f, __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f);
  if (res) {
    ru[jt] = u;
  } else {
    u1[jt * npart + c] = u;
  }
}

}  // namespace

extern "C" {

// The uniforms of iterations it0[0] .. it0[0] + n_it - 1 of t traces with
// keys (t, 2) uint32: u1 (n_it, t, npart) and ru (n_it, t) float32.
int pnr_threefry_uniforms(const void* keys, const void* it0, int t, int n_it, int npart,
                          void* u1, void* ru, void* stream) {
  const long long total = (long long)n_it * t * (npart + 1);
  if (total <= 0) return (int)cudaGetLastError();
  const int block = 256;
  const unsigned grid = (unsigned)((total + block - 1) / block);
  threefry_uniforms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)keys, (const int*)it0, t, n_it, npart, (float*)u1, (float*)ru);
  return (int)cudaGetLastError();
}

}  // extern "C"
