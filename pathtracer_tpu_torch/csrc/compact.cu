// Wavefront lane compaction for Hopper (sm_90a): a stable partition of each
// 1024-lane block of the path tracer's state.
//
// Replaces: pathtracer_tpu/ops/pallas/compact_kernel.py:compact_blocks
// (_kernel). The plain PyTorch version is
// ops/cuda/compact_kernel.py:compact_blocks_plain (the argsort partition of
// the JAX compact_blocks_ref), and the output is bit-identical to it.
//
// Design: one CTA of 1024 threads per block, one thread per lane. Each warp
// takes its live-lane mask with __ballot_sync and the in-warp rank of a live
// lane with __popc of the lower bits; the 32 warp totals go through shared
// memory and one warp scans them. A live lane then moves its 9 payload
// planes (org, dir, attn) and its LDS offset to position `rank`; lanes at
// positions >= k (the block's live count) are zeroed, and the alive plane is
// rebuilt as position < k. The TPU kernel needed a log-step shift network
// because the TPU has no per-lane scatter; here each lane scatters directly.
//
// Bound on this card: memory traffic, 11 planes read and 11 written per lane
// (~88 bytes), once per compaction. Left for later PRs: fusing the compaction
// into the bounce that precedes it, and packing rows across blocks in the
// same pass instead of the torch gather that follows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RAY_BLOCK = 1024;
constexpr int N_STATE = 10;

__global__ void __launch_bounds__(RAY_BLOCK)
    compact_kernel(const float* __restrict__ st_in,
                   const uint32_t* __restrict__ off_in,
                   float* __restrict__ st_out, uint32_t* __restrict__ off_out,
                   int* __restrict__ k_out, int n) {
  __shared__ int warp_base[32];
  __shared__ int total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t base = (size_t)blockIdx.x * RAY_BLOCK;
  const size_t src = base + threadIdx.x;

  const bool alive = st_in[(size_t)9 * n + src] > 0.0f;
  const unsigned mask = __ballot_sync(0xFFFFFFFFu, alive);
  const int rank_in_warp = __popc(mask & ((1u << lane) - 1u));
  if (lane == 0) warp_base[warp] = __popc(mask);
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the 32 warp totals
    int v = warp_base[lane];
    int incl = v;
#pragma unroll
    for (int sh = 1; sh < 32; sh <<= 1) {
      int up = __shfl_up_sync(0xFFFFFFFFu, incl, sh);
      if (lane >= sh) incl += up;
    }
    warp_base[lane] = incl - v;
    if (lane == 31) total = incl;
  }
  __syncthreads();
  const int k = total;

  if (alive) {
    const size_t dst = base + warp_base[warp] + rank_in_warp;
#pragma unroll
    for (int c = 0; c < N_STATE - 1; ++c)
      st_out[(size_t)c * n + dst] = st_in[(size_t)c * n + src];
    off_out[dst] = off_in[src];
  }
  // this thread's own position: zero the tail, rebuild alive
  if ((int)threadIdx.x >= k) {
#pragma unroll
    for (int c = 0; c < N_STATE - 1; ++c) st_out[(size_t)c * n + src] = 0.0f;
    off_out[src] = 0u;
  }
  st_out[(size_t)9 * n + src] = ((int)threadIdx.x < k) ? 1.0f : 0.0f;
  if (threadIdx.x == 0) k_out[blockIdx.x] = k;
}

}  // namespace

extern "C" {

// st_in/st_out (10, n), off_in/off_out (n,), k_out (n_blocks,); n =
// n_blocks * 1024. Returns the cudaError_t of the launch.
int pt_compact_blocks(const float* st_in, const uint32_t* off_in,
                      float* st_out, uint32_t* off_out, int* k_out,
                      int n_blocks, void* stream) {
  if (n_blocks <= 0) return (int)cudaSuccess;
  compact_kernel<<<n_blocks, RAY_BLOCK, 0, (cudaStream_t)stream>>>(
      st_in, off_in, st_out, off_out, k_out, n_blocks * RAY_BLOCK);
  return (int)cudaGetLastError();
}

}  // extern "C"
