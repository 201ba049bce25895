// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by the kernels that double-buffer their staged tables: gather_chunks.cu
// and intersect_tile_tris.cu. Each thread copies 16-byte pieces; both
// addresses must be 16-byte aligned. A thread's copies since its last
// commit form one group; wait<N> returns once at most N of the thread's
// groups are still in flight. The other threads' copies are visible only
// after a __syncthreads() that follows their waits.

#pragma once

#include <stdint.h>

namespace pt_async {

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace pt_async
