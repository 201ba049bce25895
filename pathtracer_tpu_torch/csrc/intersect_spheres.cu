// Nearest ray/sphere hit for Hopper (sm_90a): the photon mapper's sphere
// pool.
//
// Replaces: pathtracer_tpu/ops/pallas/sphere_kernel.py:intersect_spheres_pallas
// (_kernel, _kernel_body). The plain PyTorch version is
// ops/cuda/sphere_kernel.py:intersect_spheres_plain, and the output equals
// it exactly.
//
// Design: one CTA of 1024 threads per 1024-ray block, one thread per ray.
// The CTA copies the (4, S) sphere table [cx, cy, cz, A = r^2 - |c|^2] into
// shared memory; every thread then walks all S spheres with its running
// minimum (a*t key, index) in registers. The TPU kernel's block early exit
// is kept: __syncthreads_or over the alive flags, and a block with no live
// ray writes (BIG, 0); dead rays in a live block get computed values, as in
// the JAX kernel. 1/a is written for every ray (the JAX wrapper computes it
// for all rays).
//
// Numerics, kept equal to the plain version and to the JAX kernel body:
//  - the key is a*t for any |d| (not the unit-direction key of the path
//    tracer's loop): disc = g + bp*bp*(1/a), sqrt(a*disc);
//  - no --use_fast_math: a negative discriminant makes sqrtf NaN, and the
//    strict `(at < best) && (at >= 0)` update rejects it (NaN-miss);
//  - -fmad=false: every product and sum rounds on its own, in the order of
//    the JAX expression.
//
// Bound on this card: the launch and the 28 bytes a ray reads and 12 it
// writes; at S = 8 the arithmetic (~20 flops a pair) is small. Left for
// later PRs: fusing the search with the triangle search and the hit setup
// that follow it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RAY_BLOCK = 1024;
constexpr float BIG = 0x1.c363ccp+127f;  // np.float32(3.0e38)

__global__ void __launch_bounds__(RAY_BLOCK)
    intersect_spheres_kernel(const float* __restrict__ sph, int n_spheres,
                             const float* __restrict__ org,
                             const float* __restrict__ dir,
                             const uint8_t* __restrict__ alive,
                             float* __restrict__ at_out,
                             int* __restrict__ idx_out,
                             float* __restrict__ inv_a_out) {
  extern __shared__ float4 table[];  // [cx, cy, cz, A] per sphere
  for (int s = threadIdx.x; s < n_spheres; s += RAY_BLOCK)
    table[s] = make_float4(sph[s], sph[n_spheres + s], sph[2 * n_spheres + s],
                           sph[3 * n_spheres + s]);
  const size_t i = (size_t)blockIdx.x * RAY_BLOCK + threadIdx.x;
  const float d0 = dir[3 * i], d1 = dir[3 * i + 1], d2 = dir[3 * i + 2];
  const float a = d0 * d0 + d1 * d1 + d2 * d2;
  const float inv_a = 1.0f / a;
  inv_a_out[i] = inv_a;
  // also the barrier that publishes the table
  if (!__syncthreads_or(alive[i] != 0)) {
    at_out[i] = BIG;
    idx_out[i] = 0;
    return;
  }
  const float o0 = org[3 * i], o1 = org[3 * i + 1], o2 = org[3 * i + 2];
  const float od = o0 * d0 + o1 * d1 + o2 * d2;
  const float oq = o0 * o0 + o1 * o1 + o2 * o2;
  float best_at = BIG;
  int best_idx = 0;
  for (int s = 0; s < n_spheres; ++s) {
    const float4 c = table[s];
    const float bp = c.x * d0 + c.y * d1 + c.z * d2 - od;
    const float g = c.w + 2.0f * (c.x * o0 + c.y * o1 + c.z * o2) - oq;
    const float disc = g + bp * bp * inv_a;
    const float sq = sqrtf(a * disc);
    const bool inside_pos = (g >= 0.0f) && (bp >= 0.0f);
    const float at = bp + (inside_pos ? sq : -sq);
    if (at < best_at && at >= 0.0f) {
      best_at = at;
      best_idx = s;
    }
  }
  at_out[i] = best_at;
  idx_out[i] = best_idx;
}

}  // namespace

extern "C" {

// sph (4, S); org, dir (n, 3); alive (n,) bool; at, idx, inv_a (n,); all
// device pointers, n a multiple of 1024. Returns the cudaError_t.
int pt_intersect_spheres(const float* sph, int n_spheres, const float* org,
                         const float* dir, const uint8_t* alive, float* at,
                         int* idx, float* inv_a, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  intersect_spheres_kernel<<<n / RAY_BLOCK, RAY_BLOCK,
                             n_spheres * sizeof(float4),
                             (cudaStream_t)stream>>>(sph, n_spheres, org, dir,
                                                     alive, at, idx, inv_a);
  return (int)cudaGetLastError();
}

}  // extern "C"
