// BVH8 re-entry walk: nearest mesh hit per ray, for Hopper (sm_90a).
//
// Replaces: the walk of pathtracer_tpu/ops/bvh.py:make_mesh_traverser_bvh8
// (walk_pass: an XLA while_loop over all lanes, with no Pallas original).
// The plain PyTorch version is ops/cuda/bvh_walk_kernel.py:bvh8_walk_plain,
// and the output equals it exactly. Table layout: ops/bvh.py.
//
// Design: a group of G = 8 lanes per ray (the wrapper's LANES_PER_RAY,
// passed in as `lanes_per_ray` and checked), 64 threads per CTA. Every lane
// of a group
// carries the same walk state (ptr, lret, t, u, v, idx) and loops the JAX
// body's step until ptr reaches the done pointer. Each step the group reads
// its 128-byte table row with one coalesced 16-byte load per lane into the
// group's slot of shared memory, and each lane reads the words it needs
// from there. A node row: lane k tests child k's quantized box in the
// row's own frame, and
// __ballot_sync over the group gives the hit mask bh; the first hitting
// child at or after the phase is entered, and a leaf child records the
// re-entry pointer (this row at phase sel+1, or the row's exit when no
// later child hits). A triangle-pair row: lanes 0 and 1 run the two
// Moller-Trumbore tests against the old best at once, __shfl_sync hands
// both results to the group, and each lane combines them. Lanes
// need no lockstep across groups: a ray's result does not depend on the
// others, so the JAX walk's coherence sort, chunking and step caps are
// dropped. G lanes per ray keep G times the warps in flight of the
// one-thread-per-ray walk (75,776 photon lanes: 592 CTAs of 128 threads,
// ~18 warps of an SM's 64), which hides the chain of dependent row loads,
// and a row costs one 128-byte transaction instead of ~30 scalar loads.
//
// The triangle pair (csrc/bvh_walk.cuh, shared with bvh4_walk.cu): lanes
// 0 and 1 test the two triangles against the old best at once and the
// group combines them; the header proves the combine equals the
// sequential update. Numerics, kept equal to the plain version (and to
// the JAX walk): min and max propagate NaN (the header's nan_min /
// nan_max: 0 * inf of an axis-aligned ray on a box plane must miss); the
// 24-bit entry unpack uses logical shifts on uint32; the triangle test
// accepts t <= best; sel is the first hitting child, 0 when none.
// Built with -fmad=false and IEEE division.
//
// Bound on this card: the steps are dependent row loads (latency), one
// 128-byte row per step per ray; the slab tests are ~185 flops per node
// step, spread over the group. Left for later PRs: a coherence sort of the
// rays and persistent groups.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_walk.cuh"

namespace {

using pt_walk::BIG;
using pt_walk::nan_max;
using pt_walk::nan_min;

constexpr int BLOCK = 64;  // a few rays per CTA: a CTA lasts as long as
                           // its longest ray, so small CTAs free slots early
constexpr int G = 8;  // lanes per ray, one child of a node row each

__global__ void __launch_bounds__(BLOCK)
    bvh8_walk_kernel(const float4* __restrict__ table, int node_end8,
                     int stride, int done, const float* __restrict__ org,
                     const float* __restrict__ dir,
                     const float* __restrict__ t_max0,
                     const uint8_t* __restrict__ active,
                     float* __restrict__ t_out, float* __restrict__ u_out,
                     float* __restrict__ v_out, int* __restrict__ idx_out,
                     uint8_t* __restrict__ hit_out, int n) {
  __shared__ float4 rows_s[BLOCK / G][8];
  const int lane = threadIdx.x & 31;
  const int g = lane % G;  // lane within the group: the child it tests
  const int slot = threadIdx.x / G;
  const int shift = lane - g;  // the group's first lane in the warp
  const unsigned gmask = ((1u << G) - 1u) << shift;
  const int i = blockIdx.x * (BLOCK / G) + slot;
  if (i >= n) return;  // whole groups leave together
  float4* row4 = rows_s[slot];
  const float* r = reinterpret_cast<const float*>(row4);
  const int* ri = reinterpret_cast<const int*>(row4);

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
    const float4* row = table + (size_t)(ptr >> 3) * 8;
    row4[g] = __ldg(row + g);
    __syncwarp(gmask);
    if (ptr < node_end8) {
      const int phase = ptr & 7;
      const int arity = ri[25];
      float po[3], idp[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        po[a] = (o[a] - r[a]) * r[26 + a];
        idp[a] = inv_d[a] * r[3 + a];
      }
      const int k = g;
      float tn = 0.0f, tf = 0.0f;
#pragma unroll
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
      const bool hits =
          nan_max(tn, 0.0f) <= nan_min(tf, tb) && k >= phase && k < arity;
      // bit k: child k hits
      const unsigned bh = (__ballot_sync(gmask, hits) >> shift) & 0xFFu;
      const int skp = ri[24];
      int nxt = skp;
      if (bh != 0) {
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
        nxt = e_sel;
      }
      ptr = nxt;
    } else {
      pt_walk::tri_pair(r, ri, g, gmask, shift, o, d, tb, ub, vb, ib);
      ptr = r[10] > 0.5f ? lret : ptr + 8;
    }
    __syncwarp(gmask);  // every lane has read the row before the next one
  }
  if (g == 0) {
    t_out[i] = tb;
    u_out[i] = ub;
    v_out[i] = vb;
    idx_out[i] = ib;
    hit_out[i] = tb < t_lim;
  }
}

}  // namespace

extern "C" {

// table (rows, 32) f32; org, dir (n, 3) f32; t_max0 (n,) f32; active (n,)
// bool; t, u, v (n,) f32, idx (n,) int32, hit (n,) bool; all device
// pointers. node_end8 = 8 * node_end, done = 8 * (rows - 1); lanes_per_ray
// must be 8. Returns the cudaError_t of the launch.
int pt_bvh8_walk(const float* table, int node_end8, int stride, int done,
                 const float* org, const float* dir, const float* t_max0,
                 const uint8_t* active, float* t, float* u, float* v,
                 int* idx, uint8_t* hit, int n, int lanes_per_ray,
                 void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (lanes_per_ray != G) return (int)cudaErrorInvalidValue;
  bvh8_walk_kernel<<<(n + BLOCK / G - 1) / (BLOCK / G), BLOCK, 0,
                     (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(table), node_end8, stride, done, org,
      dir, t_max0, active, t, u, v, idx, hit, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
