// Asynchronous copies from device to shared memory (cp.async) with an L2
// evict-first policy, shared by the lookups that stage their operands in
// shared memory (`lookup_aligned.cu`, `lookup_window.cu`, `lookup_linear.cu`).
//
// The copies take no registers on the way, so every copy a thread issues is
// in flight at once; the policy makes the lines they touch the first to be
// evicted, so that the cost volume's lines, read about once, make room for
// each other rather than push out the lines of the GRU's other kernels.

#pragma once

#include <stdint.h>

// An L2 policy that makes the lines it touches the first to be evicted.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// 16 bytes (both addresses 16-byte aligned), bypassing L1.
__device__ __forceinline__ void copy_async16(float* dst, const float* src, uint64_t policy) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "l"(policy)
               : "memory");
}

// 4 bytes.
__device__ __forceinline__ void copy_async4(float* dst, const float* src, uint64_t policy) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "l"(policy)
               : "memory");
}

// Waits for all of the calling thread's copies.
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
