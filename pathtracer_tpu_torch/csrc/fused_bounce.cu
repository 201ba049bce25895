// One whole path-tracer bounce per launch, for Hopper (sm_90a).
//
// Replaces: pathtracer_tpu/ops/pallas/fused_bounce_kernel.py:fused_bounce_pallas
// (_kernel_fused and _kernel_fused_listed), which inlines
// sphere_kernel.py:intersect_regs / intersect_regs_listed and
// shade_kernel.py:shade_body. The plain PyTorch version of the same function
// is ops/cuda/fused_bounce_kernel.py:fused_bounce_plain. Both halves of the
// bounce, the sphere loop and the shading, are in csrc/pt_bounce.cuh, which
// the two-kernel bounce (csrc/intersect_state.cu, csrc/shade.cu) shares.
//
// Design: one thread per ray over the structure-of-arrays planes
// (state (10, n), radiance (3, n), offsets (n,)). Each CTA stages the
// sphere words in shared memory as float4 [cx, cy, cz, A], so each pair
// test reads one broadcast 16-byte word. The packed material table is read
// through the read-only cache: only the winner's 10 words are fetched. The
// running minimum (a*t key, index) stays in registers. A dead lane copies
// its state and radiance through and exits; a lane that misses adds the
// background and skips shading. The listed variant (bounce 0 in tile-major
// ray order) walks only the frustum-culled sphere list of its 1024-ray
// block, which is one 32x32 image tile. The full variant (bounces >= 1)
// walks the per-scene two-level sphere hierarchy per warp: each lane tests
// the grown bounds of the groups, eight at a time, and of the leaves of
// the groups its warp enters, and the warp tests the spheres of the leaves
// that any of its lanes may hit (csrc/pt_bounce.cuh has the walk and the
// proof that it skips no pair the brute-force loop would take).
//
// Numerics, kept equal to the plain version: no --use_fast_math (sqrtf of a
// negative must be NaN), and -fmad=false, so every product and sum rounds on
// its own, as in eager PyTorch and the Pallas interpreter; the rest is in
// csrc/pt_bounce.cuh.
//
// Bound on this card: FP32 issue in the sphere loop. Brute force over S =
// 536 spheres is 18 operations a pair; the walk runs a 17-operation node
// test per visited group or leaf and pair tests only in the leaves its
// warp enters, and a rejected pair skips the sqrt. A warp pays for the
// union of its lanes' leaves: bounce-1 rays leave one surface in random
// directions. Left for later PRs: FMA contraction (RMSE-gated), grouping
// rays so that a warp's rays agree on the leaves they enter (a regrouping
// of each CTA's rays by direction cost more than it saved over a render),
// and warp-level regrouping of divergent materials.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pt_bounce.cuh"

namespace {

constexpr int THREADS = 256;

struct Params {
  SphereArgs sa;  // sphere table, block lists or hierarchy
  ShadeArgs sh;  // packed material table, offsets, limbs, background
  const float* st_in;  // (10, n)
  float* st_out;
  const float* rad_in;  // (3, n)
  float* rad_out;
  int n;
};

template <bool LISTED, bool ORIGIN_ZERO, int BG_MODE>
__global__ void __launch_bounds__(THREADS) fused_bounce_kernel(Params p) {
  extern __shared__ float4 smem[];
  const SphereShared sph_s = stage_spheres<LISTED>(smem, p.sa);

  const int n = p.n;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;

  float st[10];
#pragma unroll
  for (int c = 0; c < 10; ++c) st[c] = p.st_in[c * n + i];
  float r_in[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) r_in[c] = p.rad_in[c * n + i];

  if (!(st[9] > 0.0f)) {  // dead lane: pass state and radiance through
    pass_through(i, n, st, r_in, p.st_out, p.rad_out);
    return;
  }

  float best_at;
  int best_idx;
  nearest_sphere<LISTED, ORIGIN_ZERO>(sph_s, p.sa, i, st, st + 3, best_at,
                                      best_idx);
  shade_store<BG_MODE>(p.sh, i, n, best_at < BIG, best_idx, st, r_in,
                       p.st_out, p.rad_out);
}

template <bool LISTED, bool ORIGIN_ZERO, int BG_MODE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kern = fused_bounce_kernel<LISTED, ORIGIN_ZERO, BG_MODE>;
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

const char* pt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// state_in/out (10, n), off (n,), rad_in/out (3, n), all device pointers;
// lists != NULL selects the listed variant, else order / nodes / links
// (the sphere hierarchy) must be given. Returns the cudaError_t.
int pt_fused_bounce(const float* sph, int n_spheres, const float* pack,
                    int pack_stride, const float* st_in, float* st_out,
                    const uint32_t* off, const float* rad_in, float* rad_out,
                    const int* lists, const int* counts, int list_k,
                    const int* order, int n_order, int n_uncond,
                    const float* nodes, const int* links, int n_nodes,
                    int n_groups,
                    uint32_t u_hi, uint32_t u_lo, uint32_t v_hi, uint32_t v_lo,
                    float bg00, float bg01, float bg02, float bg10, float bg11,
                    float bg12, int n, int bg_mode, int origin_zero,
                    void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const bool listed = lists != nullptr;
  if (!listed && order == nullptr) return (int)cudaErrorInvalidValue;
  Params p{{sph, n_spheres, lists, counts, list_k, order,
            reinterpret_cast<const float4*>(nodes),
            reinterpret_cast<const int4*>(links), n_order, n_uncond, n_nodes,
            n_groups},
           {pack, pack_stride, off, u_hi, u_lo, v_hi, v_lo,
            {bg00, bg01, bg02, bg10, bg11, bg12}},
           st_in,
           st_out,
           rad_in,
           rad_out,
           n};
  cudaStream_t s = (cudaStream_t)stream;
  const int key = (listed ? 4 : 0) | (origin_zero ? 2 : 0) | (bg_mode == 1);
  switch (key) {
    case 0: return (int)launch<false, false, 0>(p, s);
    case 1: return (int)launch<false, false, 1>(p, s);
    case 2: return (int)launch<false, true, 0>(p, s);
    case 3: return (int)launch<false, true, 1>(p, s);
    case 4: return (int)launch<true, false, 0>(p, s);
    case 5: return (int)launch<true, false, 1>(p, s);
    case 6: return (int)launch<true, true, 0>(p, s);
    default: return (int)launch<true, true, 1>(p, s);
  }
}

}  // extern "C"
