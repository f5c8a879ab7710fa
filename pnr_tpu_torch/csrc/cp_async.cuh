// Asynchronous 16-byte copies from device memory into shared memory
// (`cp.async`, sm_80 and later), shared by K1 (frangi_fused.cu) and K4
// (conv.cu). Both copy a row of a plane window from the 16-byte chunk at
// or below the row's first byte and read the row at its lead (the
// address mod 16), so rows of any alignment arrive in whole chunks.

#pragma once

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// wait until every copy this thread issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace
