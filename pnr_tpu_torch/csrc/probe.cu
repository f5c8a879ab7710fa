// Build-and-launch probe for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel inside `mosaic_available`
// (pnr_tpu/ops/pallas_conv.py), which doubles an (8, 128) float32 block
// to find out whether the backend can compile and run a Mosaic kernel.
// JAX gates every Pallas route on that probe and falls back when it fails.
// The port has no fallback: routing goes by the tensor's device, and this
// kernel only proves that the library built from csrc/ loads and launches
// on the card (ops/cuda.self_check raises otherwise).
//
// What bounds it: nothing measurable. 4 KB in and out, one block; its time
// is the launch.

#include <cuda_runtime.h>

namespace {

__global__ void probe_kernel(const float* __restrict__ in, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = in[i] * 2.0f;
}

}  // namespace

extern "C" {

// out[i] = 2 * in[i] for the n float32 values of `in`.
int pnr_probe(const void* in, void* out, int n, void* stream) {
  probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>((const float*)in, (float*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
