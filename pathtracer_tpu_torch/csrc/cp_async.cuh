// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by the kernels that double-buffer their staged tables: gather_chunks.cu,
// intersect_tile_tris.cu and gather_flux.cu. Each thread copies 16-byte
// pieces (copy16; both addresses 16-byte aligned) or 4-byte ones (copy4).
// A thread's copies since its last commit form one group; wait<N> returns
// once at most N of the thread's groups are still in flight. The other
// threads' copies are visible only after a __syncthreads() (or, within one
// warp, a __syncwarp()) that follows their waits.

#pragma once

#include <stdint.h>

namespace pt_async {

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// 4 bytes, through L1; both addresses 4-byte aligned
__device__ __forceinline__ void copy4(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
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
