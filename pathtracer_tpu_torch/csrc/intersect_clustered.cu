// Clustered nearest-hit ray/sphere-set intersection with a per-block
// bounding-sphere cull, for Hopper (sm_90a).
//
// Replaces: pathtracer_tpu/ops/pallas/sphere_kernel.py:intersect_clustered_pallas
// (_kernel_clustered). The plain PyTorch version is
// ops/cuda/sphere_kernel.py:intersect_clustered_plain, and the output
// equals it exactly. No caller renders through it: it is the clustered
// yardstick of csrc/intersect_spheres.cu, whose contract it shares.
//
// Design: one CTA of 1024 threads per 1024-ray block, one thread per ray.
// The (4, K) cluster table (bounding sphere centre and r^2) and the
// (4, 16K) sphere table ([cx, cy, cz, A], clusters of 16, pads with
// A = -BIG) are staged in shared memory as float4 (48.4 KB for shirley's
// 178 clusters). A block with no live ray writes (BIG, perm[0]). Otherwise,
// per cluster, every live lane computes the JAX kernel's cull test
// (perp^2 <= r^2 or the origin inside, and not wholly behind), and
// __syncthreads_or makes it the block's decision, as the TPU kernel's
// max-reduce over its 1024 lanes does. A cluster that some live lane may
// hit is tested by every lane of the block, dead ones too, with the
// intersect_spheres form of the sphere math: disc = g + bp^2 / a,
// sq = sqrt(a disc), an explicit `disc >= 0 && at >= 0` test and a BIG
// candidate under a strict `<`. The winner's index goes out through perm.
//
// Bound on this card: FP32 throughput, 20 operations a ray-sphere pair over
// the clusters that survive the cull, plus 17 a ray-cluster cull test;
// every CTA waits at one barrier per cluster. Left for later PRs: a warp-level
// cull (a 32-ray decision instead of a 1024-ray one) and a two-level
// cluster tree.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RAY_BLOCK = 1024;
constexpr int CLUSTER = 16;  // spheres per cluster
constexpr float BIG = 0x1.c363ccp+127f;  // np.float32(3.0e38)

__global__ void __launch_bounds__(RAY_BLOCK) intersect_clustered_kernel(
    const float* __restrict__ sph, const float* __restrict__ clus,
    int n_clusters, const int* __restrict__ perm,
    const float* __restrict__ org, const float* __restrict__ dir,
    const uint8_t* __restrict__ alive, float* __restrict__ at_out,
    int* __restrict__ idx_out, float* __restrict__ inv_a_out) {
  extern __shared__ float4 smem[];
  float4* clus_s = smem;  // [cx, cy, cz, r^2] per cluster
  float4* sph_s = smem + n_clusters;  // [cx, cy, cz, A] per sphere
  const int n_spheres = n_clusters * CLUSTER;
  for (int c = threadIdx.x; c < n_clusters; c += RAY_BLOCK)
    clus_s[c] = make_float4(clus[c], clus[n_clusters + c],
                            clus[2 * n_clusters + c], clus[3 * n_clusters + c]);
  for (int s = threadIdx.x; s < n_spheres; s += RAY_BLOCK)
    sph_s[s] = make_float4(sph[s], sph[n_spheres + s], sph[2 * n_spheres + s],
                           sph[3 * n_spheres + s]);
  const size_t i = (size_t)blockIdx.x * RAY_BLOCK + threadIdx.x;
  const float d0 = dir[3 * i], d1 = dir[3 * i + 1], d2 = dir[3 * i + 2];
  const float a = d0 * d0 + d1 * d1 + d2 * d2;
  const float inv_a = 1.0f / a;
  inv_a_out[i] = inv_a;
  const bool live = alive[i] != 0;
  float best_at = BIG;
  int best_idx = 0;
  // also the barrier that publishes the tables
  if (__syncthreads_or(live)) {
    const float o0 = org[3 * i], o1 = org[3 * i + 1], o2 = org[3 * i + 2];
    const float od = o0 * d0 + o1 * d1 + o2 * d2;
    const float oq = o0 * o0 + o1 * o1 + o2 * o2;
    for (int ci = 0; ci < n_clusters; ++ci) {
      const float4 c = clus_s[ci];
      const float fx = c.x - o0, fy = c.y - o1, fz = c.z - o2;
      const float fb = fx * d0 + fy * d1 + fz * d2;
      const float fq = fx * fx + fy * fy + fz * fz;
      const float perp2 = fq - fb * fb * inv_a;
      const bool may_hit = ((perp2 <= c.w) || (fq <= c.w)) &&
                           (fb >= -sqrtf(c.w * a)) && live;
      if (!__syncthreads_or(may_hit)) continue;
      for (int j = 0; j < CLUSTER; ++j) {
        const int s = ci * CLUSTER + j;
        const float4 sp = sph_s[s];
        const float bp = sp.x * d0 + sp.y * d1 + sp.z * d2 - od;
        const float g = sp.w + 2.0f * (sp.x * o0 + sp.y * o1 + sp.z * o2) - oq;
        const float disc = g + bp * bp * inv_a;
        const float sq = sqrtf(a * disc);
        const bool inside_pos = (g >= 0.0f) && (bp >= 0.0f);
        const float at = bp + (inside_pos ? sq : -sq);
        const float cand = (disc >= 0.0f && at >= 0.0f) ? at : BIG;
        if (cand < best_at) {
          best_at = cand;
          best_idx = s;
        }
      }
    }
  }
  at_out[i] = best_at;
  idx_out[i] = perm[best_idx];
}

}  // namespace

extern "C" {

// sph (4, 16 K), clus (4, K), perm (16 K,) int32; org, dir (n, 3); alive
// (n,) bool; at, idx, inv_a (n,); all device pointers, n a multiple of 1024.
// Returns the cudaError_t.
int pt_intersect_clustered(const float* sph, const float* clus,
                           int n_clusters, const int* perm, const float* org,
                           const float* dir, const uint8_t* alive, float* at,
                           int* idx, float* inv_a, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float4) * (size_t)n_clusters * (1 + CLUSTER);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        intersect_clustered_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  intersect_clustered_kernel<<<n / RAY_BLOCK, RAY_BLOCK, smem,
                               (cudaStream_t)stream>>>(
      sph, clus, n_clusters, perm, org, dir, alive, at, idx, inv_a);
  return (int)cudaGetLastError();
}

}  // extern "C"
