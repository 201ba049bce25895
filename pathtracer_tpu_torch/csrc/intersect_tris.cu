// Nearest ray/triangle hit (Moller-Trumbore) for Hopper (sm_90a): the
// triangle pool of mixed scenes (cornell-box's walls and light box).
//
// Replaces: pathtracer_tpu/ops/pallas/tri_kernel.py:intersect_tris_pallas
// (_kernel). The plain PyTorch version is
// ops/cuda/tri_kernel.py:intersect_tris_plain, and the output equals it
// exactly.
//
// Design: one CTA of 1024 threads per 1024-ray block, one thread per ray.
// The CTA copies the (9, T) table [a, e1, e2 by component] into shared
// memory (4.6 KB at T = 128); each thread walks all T triangles with its
// running minimum (t, index) in registers. The block early exit of the JAX
// kernel is kept: a block with no live ray writes (BIG, 0).
//
// Numerics, kept equal to the plain version: the operations of the JAX
// kernel in its order (pvec = d x e2, det, det_inv = 1/det, u, qvec =
// tvec x e1, v, t), the six acceptance tests (|det| >= 1e-6, 0 <= u <= 1,
// v >= 0, u + v <= 1, t >= 0), and the strict `cand < best` update, so ties
// go to the lowest index. Built with -fmad=false and IEEE division.
//
// Bound on this card: FP32 issue, ~40 flops and one division a
// ray-triangle pair over T = 128 (18 valid; the padding triangles are
// tested too, as in the JAX kernel). Left for later PRs: walking only the
// valid prefix, and fusing with the sphere search.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RAY_BLOCK = 1024;
constexpr float BIG = 0x1.c363ccp+127f;  // np.float32(3.0e38)
constexpr float EPS = 0x1.0c6f7ap-20f;  // np.float32(1e-6)

__global__ void __launch_bounds__(RAY_BLOCK)
    intersect_tris_kernel(const float* __restrict__ tab, int n_tris,
                          const float* __restrict__ org,
                          const float* __restrict__ dir,
                          const uint8_t* __restrict__ alive,
                          float* __restrict__ t_out,
                          int* __restrict__ idx_out) {
  extern __shared__ float table[];  // (9, T), the input's layout
  for (int e = threadIdx.x; e < 9 * n_tris; e += RAY_BLOCK) table[e] = tab[e];
  const size_t i = (size_t)blockIdx.x * RAY_BLOCK + threadIdx.x;
  // also the barrier that publishes the table
  if (!__syncthreads_or(alive[i] != 0)) {
    t_out[i] = BIG;
    idx_out[i] = 0;
    return;
  }
  const float d0 = dir[3 * i], d1 = dir[3 * i + 1], d2 = dir[3 * i + 2];
  const float o0 = org[3 * i], o1 = org[3 * i + 1], o2 = org[3 * i + 2];
  float best_t = BIG;
  int best_idx = 0;
  for (int s = 0; s < n_tris; ++s) {
    const float ax = table[s], ay = table[n_tris + s], az = table[2 * n_tris + s];
    const float e1x = table[3 * n_tris + s], e1y = table[4 * n_tris + s],
                e1z = table[5 * n_tris + s];
    const float e2x = table[6 * n_tris + s], e2y = table[7 * n_tris + s],
                e2z = table[8 * n_tris + s];
    const float pvx = d1 * e2z - d2 * e2y;  // pvec = d x e2
    const float pvy = d2 * e2x - d0 * e2z;
    const float pvz = d0 * e2y - d1 * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const float det_inv = 1.0f / det;
    const float tvx = o0 - ax, tvy = o1 - ay, tvz = o2 - az;
    const float uu = det_inv * (tvx * pvx + tvy * pvy + tvz * pvz);
    const float qvx = tvy * e1z - tvz * e1y;  // qvec = tvec x e1
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float vv = det_inv * (d0 * qvx + d1 * qvy + d2 * qvz);
    const float tt = det_inv * (e2x * qvx + e2y * qvy + e2z * qvz);
    const bool ok = (fabsf(det) >= EPS) && (uu >= 0.0f) && (uu <= 1.0f) &&
                    (vv >= 0.0f) && (uu + vv <= 1.0f) && (tt >= 0.0f);
    const float cand = ok ? tt : BIG;
    if (cand < best_t) {
      best_t = cand;
      best_idx = s;
    }
  }
  t_out[i] = best_t;
  idx_out[i] = best_idx;
}

}  // namespace

extern "C" {

// tab (9, T); org, dir (n, 3); alive (n,) bool; t, idx (n,); all device
// pointers, n a multiple of 1024. Returns the cudaError_t.
int pt_intersect_tris(const float* tab, int n_tris, const float* org,
                      const float* dir, const uint8_t* alive, float* t,
                      int* idx, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  intersect_tris_kernel<<<n / RAY_BLOCK, RAY_BLOCK,
                          9 * n_tris * sizeof(float), (cudaStream_t)stream>>>(
      tab, n_tris, org, dir, alive, t, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
