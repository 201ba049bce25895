// Nearest sphere over the path tracer's wavefront state, for Hopper
// (sm_90a): the intersection half of the two-kernel bounce.
//
// Replaces: pathtracer_tpu/ops/pallas/sphere_kernel.py:intersect_state_pallas
// (_kernel_state and _kernel_state_listed). The plain PyTorch version is
// ops/cuda/sphere_kernel.py:intersect_state_plain, and the output equals it
// exactly.
//
// Design: one thread per ray, as in csrc/fused_bounce.cu, whose sphere loop
// this kernel runs (`stage_spheres` and `nearest_sphere` of
// csrc/pt_bounce.cuh: the block's list at bounce 0, the per-warp walk of
// the sphere hierarchy at bounces >= 1): each CTA stages the sphere words
// in shared memory as float4, each live lane keeps its running minimum
// (a*t key, index) in registers and writes it once. Only the origin, direction and
// alive planes of the (10, n) state are read. A dead lane writes (BIG, 0)
// without testing a sphere: the shading half reads `at` only where the lane
// is alive, and the JAX kernel's dead lanes of a live block hold values that
// nothing reads.
//
// Bound on this card: FP32 throughput in the sphere loop at bounces >= 1
// (18 operations a ray-sphere pair, node tests and the pairs of the
// entered leaves under the walk), as in the fused bounce; the 8 bytes a
// lane writes and the 28 it reads are small beside it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pt_bounce.cuh"

namespace {

constexpr int THREADS = 256;

struct Params {
  SphereArgs sa;  // sphere table, block lists or hierarchy
  const float* st;  // (10, n)
  float* at;  // (n,)
  int* idx;  // (n,)
  int n;
};

template <bool LISTED, bool ORIGIN_ZERO>
__global__ void __launch_bounds__(THREADS) intersect_state_kernel(Params p) {
  extern __shared__ float4 smem[];
  const SphereShared sph_s = stage_spheres<LISTED>(smem, p.sa);

  const int n = p.n;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float best_at = BIG;
  int best_idx = 0;
  if (p.st[9 * (size_t)n + i] > 0.0f) {
    float o[3], d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = p.st[c * (size_t)n + i];
      d[c] = p.st[(3 + c) * (size_t)n + i];
    }
    nearest_sphere<LISTED, ORIGIN_ZERO>(sph_s, p.sa, i, o, d, best_at,
                                        best_idx);
  }
  p.at[i] = best_at;
  p.idx[i] = best_idx;
}

template <bool LISTED, bool ORIGIN_ZERO>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kern = intersect_state_kernel<LISTED, ORIGIN_ZERO>;
  size_t smem = sphere_smem_bytes(p.sa, LISTED);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  int grid = (p.n + THREADS - 1) / THREADS;
  kern<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// state (10, n), at (n,), idx (n,), all device pointers; lists != NULL
// selects the listed variant, else order / nodes / links (the sphere
// hierarchy) must be given. Returns the cudaError_t.
int pt_intersect_state(const float* sph, int n_spheres, const float* st,
                       const int* lists, const int* counts, int list_k,
                       const int* order, int n_order, int n_uncond,
                       const float* nodes, const int* links, int n_nodes,
                       int n_groups,
                       float* at, int* idx, int n, int origin_zero,
                       void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (lists == nullptr && order == nullptr) return (int)cudaErrorInvalidValue;
  Params p{{sph, n_spheres, lists, counts, list_k, order,
            reinterpret_cast<const float4*>(nodes),
            reinterpret_cast<const int4*>(links), n_order, n_uncond, n_nodes,
            n_groups},
           st, at, idx, n};
  cudaStream_t s = (cudaStream_t)stream;
  const int key = (lists != nullptr ? 2 : 0) | (origin_zero ? 1 : 0);
  switch (key) {
    case 0: return (int)launch<false, false>(p, s);
    case 1: return (int)launch<false, true>(p, s);
    case 2: return (int)launch<true, false>(p, s);
    default: return (int)launch<true, true>(p, s);
  }
}

}  // extern "C"
