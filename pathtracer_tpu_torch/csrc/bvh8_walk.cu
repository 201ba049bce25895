// BVH8 re-entry walk: nearest mesh hit per ray, for Hopper (sm_90a).
//
// Replaces: the walk of pathtracer_tpu/ops/bvh.py:make_mesh_traverser_bvh8
// (walk_pass: an XLA while_loop over all lanes, with no Pallas original).
// The plain PyTorch version is ops/cuda/bvh_walk_kernel.py:bvh8_walk_plain,
// and the output equals it exactly. Table layout: ops/bvh.py.
//
// Design: one thread per ray, 128 threads per CTA. A thread carries the
// walk state (ptr, lret, t, u, v, idx) in registers and loops the JAX
// body's step until ptr reaches the done pointer, reading one 128-byte
// table row from global memory per step (through L1/L2; the 73 MB ganesha
// table fits the 50 MB L2 only in part). A node row tests its up to 8
// children's quantized boxes in the row's own frame; the first hitting
// child at or after the phase is entered, and a leaf child records the
// re-entry pointer (this row at phase sel+1, or the row's exit when no
// later child hits). A triangle-pair row runs two Moller-Trumbore tests
// and moves to the next pair or to the recorded re-entry pointer. Lanes
// need no lockstep: a lane's result does not depend on the others, so the
// JAX walk's coherence sort, chunking and step caps are dropped.
//
// Numerics, kept equal to the plain version (and to the JAX walk):
// - min and max propagate NaN (jnp.minimum / maximum, torch.minimum /
//   maximum): 1/d of an axis-aligned ray is +-inf and (q - po) * idp can be
//   0 * inf = NaN, which must make the child miss. fminf / fmaxf would
//   drop the NaN, so the kernel uses nan_min / nan_max below.
// - the 24-bit entry unpack uses logical shifts on uint32;
// - the triangle test accepts t <= best (the tile kernel's is strict);
// - sel is the first hitting child, 0 when none.
// Built with -fmad=false and IEEE division.
//
// Bound on this card: the steps are dependent global loads (latency), one
// row per step per lane; the slab tests are ~150 flops per node step.
// Left for later PRs: a coherence sort of the rays, persistent threads,
// and the row in shared memory or registers as 8 float4 loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr float BIG = 0x1.c363ccp+127f;  // np.float32(3.0e38)
constexpr float EPS = 0x1.0c6f7ap-20f;  // np.float32(1e-6)

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// One Moller-Trumbore test against the triangle at row columns
// [c, c + 9), index at column c + 9; updates the best where it accepts.
__device__ __forceinline__ void mt_update(const float* __restrict__ r,
                                          const int* __restrict__ ri, int c,
                                          const float o[3], const float d[3],
                                          float& tb, float& ub, float& vb,
                                          int& ib) {
  const float ax = r[c], ay = r[c + 1], az = r[c + 2];
  const float e1x = r[c + 3], e1y = r[c + 4], e1z = r[c + 5];
  const float e2x = r[c + 6], e2y = r[c + 7], e2z = r[c + 8];
  const float pvx = d[1] * e2z - d[2] * e2y;  // pvec = d x e2
  const float pvy = d[2] * e2x - d[0] * e2z;
  const float pvz = d[0] * e2y - d[1] * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float det_inv = 1.0f / det;
  const float tvx = o[0] - ax, tvy = o[1] - ay, tvz = o[2] - az;
  const float uu = det_inv * (tvx * pvx + tvy * pvy + tvz * pvz);
  const float qvx = tvy * e1z - tvz * e1y;  // qvec = tvec x e1
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float vv = det_inv * (d[0] * qvx + d[1] * qvy + d[2] * qvz);
  const float tt = det_inv * (e2x * qvx + e2y * qvy + e2z * qvz);
  if ((fabsf(det) >= EPS) && (uu >= 0.0f) && (uu <= 1.0f) &&
      (vv >= 0.0f) && (uu + vv <= 1.0f) && (tt >= 0.0f) && (tt <= tb)) {
    tb = tt;
    ub = uu;
    vb = vv;
    ib = ri[c + 9];
  }
}

__global__ void __launch_bounds__(BLOCK)
    bvh8_walk_kernel(const float* __restrict__ table, int node_end8,
                     int stride, int done, const float* __restrict__ org,
                     const float* __restrict__ dir,
                     const float* __restrict__ t_max0,
                     const uint8_t* __restrict__ active,
                     float* __restrict__ t_out, float* __restrict__ u_out,
                     float* __restrict__ v_out, int* __restrict__ idx_out,
                     uint8_t* __restrict__ hit_out, int n) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const float o[3] = {org[3 * i], org[3 * i + 1], org[3 * i + 2]};
  const float d[3] = {dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]};
  const float inv_d[3] = {1.0f / d[0], 1.0f / d[1], 1.0f / d[2]};
  const int oct = (d[0] < 0.0f) * 4 + (d[1] < 0.0f) * 2 + (d[2] < 0.0f);
  const float t_lim = nan_min(t_max0[i], BIG);
  int ptr = active[i] ? oct * (8 * stride) : done;
  int lret = done;
  float tb = t_lim, ub = 0.0f, vb = 0.0f;
  int ib = 0;
  while (ptr != done) {
    const float* r = table + (size_t)(ptr >> 3) * 32;
    const int* ri = reinterpret_cast<const int*>(r);
    if (ptr < node_end8) {
      const int phase = ptr & 7;
      const int arity = ri[25];
      float po[3], idp[3];
      for (int a = 0; a < 3; ++a) {
        po[a] = (o[a] - r[a]) * r[26 + a];
        idp[a] = inv_d[a] * r[3 + a];
      }
      unsigned bh = 0;  // bit k: child k hits
      for (int k = 0; k < 8; ++k) {
        float tn = 0.0f, tf = 0.0f;
        for (int a = 0; a < 3; ++a) {
          const int b = 2 * (3 * k + a);  // byte of qlo; qhi follows
          const uint32_t w = (uint32_t)ri[6 + (b >> 2)];
          const float qlo = (float)((w >> (8 * (b & 3))) & 0xFFu);
          const float qhi = (float)((w >> (8 * (b & 3) + 8)) & 0xFFu);
          const float t0 = (qlo - po[a]) * idp[a];
          const float t1 = (qhi - po[a]) * idp[a];
          const float lo = nan_min(t0, t1), hi = nan_max(t0, t1);
          tn = a ? nan_max(tn, lo) : lo;
          tf = a ? nan_min(tf, hi) : hi;
        }
        if (nan_max(tn, 0.0f) <= nan_min(tf, tb) && k >= phase && k < arity)
          bh |= 1u << k;
      }
      const int skp = ri[24];
      if (bh == 0) {
        ptr = skp;
        continue;
      }
      const int sel = __ffs(bh) - 1;
      // the 24-bit little-endian entry of child sel, logical shifts
      const int bo = 3 * sel, c = bo >> 2, sh = (bo & 3) * 8;
      uint32_t raw = (uint32_t)ri[18 + c] >> sh;
      if (sh > 8) raw |= (uint32_t)ri[18 + c + 1] << (32 - sh);
      const int e_sel = (int)(raw & 0xFFFFFFu) & ~7;
      if (e_sel >= node_end8) {  // a leaf child: where to come back to
        const bool beyond = (bh >> (sel + 1)) != 0;
        lret = beyond ? (ptr & ~7) + sel + 1 : skp;
      }
      ptr = e_sel;
    } else {
      mt_update(r, ri, 0, o, d, tb, ub, vb, ib);
      mt_update(r, ri, 12, o, d, tb, ub, vb, ib);
      ptr = r[10] > 0.5f ? lret : ptr + 8;
    }
  }
  t_out[i] = tb;
  u_out[i] = ub;
  v_out[i] = vb;
  idx_out[i] = ib;
  hit_out[i] = tb < t_lim;
}

}  // namespace

extern "C" {

// table (rows, 32) f32; org, dir (n, 3) f32; t_max0 (n,) f32; active (n,)
// bool; t, u, v (n,) f32, idx (n,) int32, hit (n,) bool; all device
// pointers. node_end8 = 8 * node_end, done = 8 * (rows - 1). Returns the
// cudaError_t of the launch.
int pt_bvh8_walk(const float* table, int node_end8, int stride, int done,
                 const float* org, const float* dir, const float* t_max0,
                 const uint8_t* active, float* t, float* u, float* v,
                 int* idx, uint8_t* hit, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  bvh8_walk_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                     (cudaStream_t)stream>>>(table, node_end8, stride, done,
                                             org, dir, t_max0, active, t, u,
                                             v, idx, hit, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
