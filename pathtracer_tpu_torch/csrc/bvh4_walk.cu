// BVH4 re-entry walk: nearest mesh hit per ray, for Hopper (sm_90a).
//
// Replaces: the walk of pathtracer_tpu/ops/bvh.py:make_mesh_traverser_bvh4
// (walk_pass: an XLA while_loop over all lanes, with no Pallas original),
// which MeshBVH takes for a mesh past the BVH8 table's 24-bit entries.
// The plain PyTorch version is ops/cuda/bvh_walk_kernel.py:bvh4_walk_plain,
// and the output equals it exactly. Table layout: ops/bvh.py.
//
// Design: bvh8_walk.cu's, with a group of G = 4 lanes per ray (the
// wrapper's BVH4_LANES_PER_RAY, passed in as `lanes_per_ray` and checked),
// 64 threads per CTA. Every lane of a group carries the same walk state
// (ptr, lret, t, u, v, idx) and loops the JAX body's step until ptr
// reaches the done pointer. Each step the group stages its 128-byte table
// row in its slot of shared memory, two coalesced 16-byte loads per lane.
// A node row: lane k tests child k's world-space box (columns 6k..6k+5),
// and __ballot_sync over the group gives the hit mask bh; the first
// hitting child at or after the phase is entered (int column 24+sel), and
// a leaf child records the re-entry pointer: the row's exit (column 28)
// when sel is its last child (column 29 holds the arity), else this row
// at phase sel+1. A triangle-pair row: csrc/bvh_walk.cuh's two-lane
// combine, the same rows as the BVH8 table's. A ray's result does not
// depend on the other rays, so the JAX walk's coherence sort, chunking
// and step caps are dropped.
//
// Numerics, kept equal to the plain version (and to the JAX walk): the
// slab tests are (box - o) * (1/d) with IEEE division; their min and max
// propagate NaN (nan_min / nan_max of the header), so a NaN pad box past
// the arity misses, as does 0 * inf of an axis-aligned ray on a box
// plane; the triangle test accepts t <= best. Built with -fmad=false.
//
// Bound on this card: as the BVH8 walk's, a chain of dependent 128-byte
// row loads per ray (latency), with ~88 flops per node row (4 children x
// 3 axes x 6 slab operations, 16 for the children's min/max reductions)
// and ~46 a triangle. The BVH4 table resolves 4 children a row, not 8,
// so a ray takes more steps than in the BVH8 table. Left for later PRs:
// a coherence sort of the rays and persistent groups.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_walk.cuh"

namespace {

using pt_walk::BIG;
using pt_walk::nan_max;
using pt_walk::nan_min;

constexpr int BLOCK = 64;  // a few rays per CTA: a CTA lasts as long as
                           // its longest ray, so small CTAs free slots early
constexpr int G = 4;  // lanes per ray, one child of a node row each

__global__ void __launch_bounds__(BLOCK)
    bvh4_walk_kernel(const float4* __restrict__ table, int node_end4,
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
  int ptr = active[i] ? oct * (4 * stride) : done;
  int lret = done;
  float tb = t_lim, ub = 0.0f, vb = 0.0f;
  int ib = 0;
  while (ptr != done) {
    const float4* row = table + (size_t)(ptr >> 2) * 8;
    row4[g] = __ldg(row + g);
    row4[g + G] = __ldg(row + g + G);
    __syncwarp(gmask);
    if (ptr < node_end4) {
      const int phase = ptr & 3;
      const int k = g;
      float tn = 0.0f, tf = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float t0 = (r[6 * k + a] - o[a]) * inv_d[a];
        const float t1 = (r[6 * k + 3 + a] - o[a]) * inv_d[a];
        const float lo = nan_min(t0, t1), hi = nan_max(t0, t1);
        tn = a ? nan_max(tn, lo) : lo;
        tf = a ? nan_min(tf, hi) : hi;
      }
      const bool hits = nan_max(tn, 0.0f) <= nan_min(tf, tb) && k >= phase;
      // bit k: child k hits
      const unsigned bh = (__ballot_sync(gmask, hits) >> shift) & 0xFu;
      const int skp = ri[28];
      int nxt = skp;
      if (bh != 0) {
        const int sel = __ffs(bh) - 1;
        const int e_sel = ri[24 + sel];
        if (e_sel >= node_end4)  // a leaf child: where to come back to
          lret = sel == ri[29] - 1 ? skp : (ptr & ~3) + sel + 1;
        nxt = e_sel;
      }
      ptr = nxt;
    } else {
      pt_walk::tri_pair(r, ri, g, gmask, shift, o, d, tb, ub, vb, ib);
      ptr = r[10] > 0.5f ? lret : ptr + 4;
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
// pointers. node_end4 = 4 * node_end, done = 4 * (rows - 1); lanes_per_ray
// must be 4. Returns the cudaError_t of the launch.
int pt_bvh4_walk(const float* table, int node_end4, int stride, int done,
                 const float* org, const float* dir, const float* t_max0,
                 const uint8_t* active, float* t, float* u, float* v,
                 int* idx, uint8_t* hit, int n, int lanes_per_ray,
                 void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (lanes_per_ray != G) return (int)cudaErrorInvalidValue;
  bvh4_walk_kernel<<<(n + BLOCK / G - 1) / (BLOCK / G), BLOCK, 0,
                     (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(table), node_end4, stride, done, org,
      dir, t_max0, active, t, u, v, idx, hit, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
