// BVH4 re-entry walk: nearest mesh hit per ray, for Hopper (sm_90a).
//
// Replaces: the walk of pathtracer_tpu/ops/bvh.py:make_mesh_traverser_bvh4
// (walk_pass: an XLA while_loop over all lanes, with no Pallas original),
// which MeshBVH takes for a mesh past the BVH8 table's 24-bit entries.
// The plain PyTorch version is ops/cuda/bvh_walk_kernel.py:bvh4_walk_plain,
// and the output equals it exactly; bvh4_walk_cached_plain there emulates
// this kernel's steps (the cache and the leaf step) and counts them.
// Table layout: ops/bvh.py.
//
// Bound on this card: latency, not bytes (the walk reaches 3-7% of its
// bytes' bound) nor operations (~88 flops per node row: 4 children x 3
// axes x 6 slab operations, 16 for the children's min/max reductions; ~46
// a triangle). A ray's steps form one dependent chain, each step a
// 128-byte row load and then a dependent chain of instructions (slab
// tests, ballot, the next pointer) about as long as the load on this card
// (measured with one ray a warp: PERF.md), and a warp's 8 rays pay for
// each other's steps. The design takes the loads out of the chain where a
// step needs no new row, and shortens the instructions:
//
// - A group of G = 4 lanes per ray (the wrapper's BVH4_LANES_PER_RAY,
//   passed in as `lanes_per_ray` and checked), 64 threads per CTA. Every
//   lane of a group carries the same walk state (ptr, lret, t, u, v, idx)
//   and loops the JAX body's step until ptr reaches the done pointer. On
//   a node row lane k tests child k's world-space box (columns 6k..6k+5),
//   __ballot_sync gives the hit mask, the first hitting child at or after
//   the phase is entered (int column 24+sel), and a leaf child records the
//   re-entry pointer: the row's exit (column 28) when sel is its last child
//   (column 29 holds the arity), else this row at phase sel+1.
// - A path cache of node rows in shared memory: each ray keeps the last
//   K = 4 node rows it read from the table in a ring of K slots used as a
//   LIFO (top: the newest slot, cnt: the slots in use); lane g holds the
//   row indices of slots g + G j as their tags. A node row at phase 0 is
//   a first visit: it is loaded (two float4 a lane) into the slot above
//   top, the oldest row dropped when the ring is full. A node row at
//   phase > 0 is a return to a row of the ray's current root-to-node path
//   (a leaf's return goes to its parent, an exit to an ancestor), so the
//   group looks it up, K / G compares a lane and as many ballots: on a
//   hit the row is read from its slot and the slots above it are popped
//   (their subtrees are done); on a miss every cached row lies below the
//   missed one, so the ring is emptied and the row loaded as at phase 0.
//   A tag equals a row index only for that row's unchanged copy, so the
//   same rows are tested in the same order: no bit of the result depends
//   on the cache.
// - A leaf's triangle-pair rows two at a time: lane g loads triangle g of
//   the leaf's next two rows (its 48 bytes, three float4, into registers)
//   and tests it against the best before the step; the second row's two
//   only count where the first is not the leaf's last (column 10). The
//   four results combine as csrc/bvh_walk.cuh's tri_quad (proof there);
//   then the leaf returns, or the next step takes the two rows after. The
//   row after a leaf's last row is read and not used: it exists, since
//   the all-zero done row ends the table.
// - One table load an iteration: the 8 groups of a warp run each loop
//   iteration together, so an iteration costs the latency of any load in
//   it. Each iteration therefore takes one step that reads the table (a
//   node row not in the cache, or a leaf's rows), with the node's and the
//   leaf's loads issued by the same instructions (three float4 a lane)
//   before their code parts, and then every step that the cache serves,
//   until the next step needs the table again. A ray's iterations are its
//   table loads, not its steps.
// A ray's result does not depend on the other rays, so the JAX walk's
// coherence sort, chunking and step caps are dropped.
//
// Counters: counts[0] += the active rays walked and counts[1] += their
// table loads, the loop's iterations (what
// bvh4_walk_cached_plain counts as its table loads). A group's lanes carry
// the same count; each warp sums its groups' (__reduce_add_sync over the
// lanes of its rays that exist) and adds them with one atomic a counter.
//
// Synchronisation: a slot is written only on a load, between two
// __syncwarp(gmask) (every lane has read the slot's old row; every lane
// sees the new one). A step reads only the slot at top, and a load writes
// the slot above it, so a cache hit needs no barrier.
//
// Numerics, kept equal to the plain version (and to the JAX walk): the
// slab tests are (box - o) * (1/d) with IEEE division; a NaN among a
// child's slab distances makes it miss, as the plain version's
// NaN-propagating min and max do (node_step: a NaN flag beside fminf and
// fmaxf, the same bit), so a NaN pad box past the arity misses, as does
// 0 * inf of an axis-aligned ray on a box plane; the triangle test
// accepts t <= best. Built with -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_walk.cuh"

namespace {

using pt_walk::BIG;
using pt_walk::nan_min;

constexpr int BLOCK = 64;  // a few rays per CTA: a CTA lasts as long as
                           // its longest ray, so small CTAs free slots early
constexpr int G = 4;  // lanes per ray, one child of a node row each
constexpr int K = 4;  // node rows of a ray's path cache (the plain
                      // emulation's BVH4_CACHE_ROWS; pt_bvh4_cache_rows)
constexpr int TAGS = K / G;  // lane g holds the tags of slots g + G j
static_assert(K % G == 0 && (K & (K - 1)) == 0 && K <= 32,
              "K: a power of two, a multiple of G, one ballot bit a slot");

// A node row's step for one lane of a group: child g's slab test against
// the best tb, the hit mask by ballot, the first hitting child at or after
// the phase entered; a leaf child sets the leaf-return pointer lret.
// Returns the next pointer. r, ri: the row (float and int views).
//
// The test is nan_max(tn, 0) <= nan_min(tf, tb) of the NaN-propagating
// chains (csrc/bvh_walk.cuh). A NaN among the six slab distances, or in tb,
// reaches tn or tf or the right side there and makes it false; without
// one, nan_min and nan_max are fminf and fmaxf on the same operands. So
// the test is "no NaN" and the fminf / fmaxf chains: the same bit, on a
// shorter chain of dependent instructions. The row's entries and exit are
// read before the ballot, so no shared load waits on its result.
__device__ __forceinline__ int node_step(const float* r, const int* ri,
                                         int ptr, int g, unsigned gmask,
                                         int shift, const float o[3],
                                         const float inv_d[3], float tb,
                                         int node_end4, int& lret) {
  const int phase = ptr & 3;
  const int4 entry = *reinterpret_cast<const int4*>(ri + 24);
  const int2 exit_arity = *reinterpret_cast<const int2*>(ri + 28);
  float tn = 0.0f, tf = 0.0f;
  bool nan = tb != tb;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (r[6 * g + a] - o[a]) * inv_d[a];
    const float t1 = (r[6 * g + 3 + a] - o[a]) * inv_d[a];
    nan = nan || t0 != t0 || t1 != t1;
    const float lo = fminf(t0, t1), hi = fmaxf(t0, t1);
    tn = a ? fmaxf(tn, lo) : lo;
    tf = a ? fminf(tf, hi) : hi;
  }
  const bool hits = !nan && fmaxf(tn, 0.0f) <= fminf(tf, tb) && g >= phase;
  // bit k: child k hits
  const unsigned bh = (__ballot_sync(gmask, hits) >> shift) & 0xFu;
  const int skp = exit_arity.x;
  if (bh == 0) return skp;
  const int sel = __ffs(bh) - 1;
  const int e_sel = sel == 0   ? entry.x
                    : sel == 1 ? entry.y
                    : sel == 2 ? entry.z
                               : entry.w;
  if (e_sel >= node_end4)  // a leaf child: where to come back to
    lret = sel == exit_arity.y - 1 ? skp : (ptr & ~3) + sel + 1;
  return e_sel;
}

__global__ void __launch_bounds__(BLOCK)
    bvh4_walk_kernel(const float4* __restrict__ table, int node_end4,
                     int stride, int done, const float* __restrict__ org,
                     const float* __restrict__ dir,
                     const float* __restrict__ t_max0,
                     const uint8_t* __restrict__ active,
                     float* __restrict__ t_out, float* __restrict__ u_out,
                     float* __restrict__ v_out, int* __restrict__ idx_out,
                     uint8_t* __restrict__ hit_out,
                     unsigned long long* __restrict__ counts, int n) {
  __shared__ float4 cache_s[BLOCK / G][K][8];
  const int lane = threadIdx.x & 31;
  const int g = lane % G;  // lane within the group: the child it tests
  const int ray = threadIdx.x / G;
  const int shift = lane - g;  // the group's first lane in the warp
  const unsigned gmask = ((1u << G) - 1u) << shift;
  const int i = blockIdx.x * (BLOCK / G) + ray;
  // the warp's lanes whose ray exists: each reaches the counters' sums
  const unsigned rays_mask = __ballot_sync(0xffffffffu, i < n);
  if (i >= n) return;  // whole groups leave together
  float4(*cache)[8] = cache_s[ray];

  const float o[3] = {org[3 * i], org[3 * i + 1], org[3 * i + 2]};
  const float d[3] = {dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]};
  const float inv_d[3] = {1.0f / d[0], 1.0f / d[1], 1.0f / d[2]};
  const int oct = (d[0] < 0.0f) * 4 + (d[1] < 0.0f) * 2 + (d[2] < 0.0f);
  const float t_lim = nan_min(t_max0[i], BIG);
  const bool walked = active[i] != 0;
  int ptr = walked ? oct * (4 * stride) : done;
  int lret = done;
  float tb = t_lim, ub = 0.0f, vb = 0.0f;
  int ib = 0;
  int top = 0, cnt = 0;  // the cache's newest slot, and its slots in use
  int tag[TAGS];         // the table rows in slots g + G j
  unsigned loads = 0;    // the iterations: the ray's table loads
#pragma unroll
  for (int j = 0; j < TAGS; ++j) tag[j] = -1;
  // An iteration: the one step that reads the table, then the steps that
  // the cache serves (returns to a cached row of the path).
  while (ptr != done) {
    ++loads;
    // The table load, one for node and leaf groups alike: a node row's
    // float4 g and g + G, or triangle g of a leaf's next two rows, its
    // columns 12 (g & 1) .. +11 of row ptr / 4 + g / 2 (a, e1, e2, the
    // index, the last-row flag). A node lane's third float4 is unused.
    const bool leaf = ptr >= node_end4;
    const float4* src =
        leaf ? table + (size_t)((ptr >> 2) + (g >> 1)) * 8 + 3 * (g & 1)
             : table + (size_t)(ptr >> 2) * 8 + g;
    const float4 q0 = __ldg(src), q1 = __ldg(src + (leaf ? 1 : G)),
                 q2 = __ldg(src + 2);
    if (leaf) {
      const float tri[9] = {q0.x, q0.y, q0.z, q0.w, q1.x,
                            q1.y, q1.z, q1.w, q2.x};
      const bool last0 = __shfl_sync(gmask, q2.z, shift) > 0.5f;
      const bool last1 = __shfl_sync(gmask, q2.z, shift + 2) > 0.5f;
      float tt = 0.0f, uu = 0.0f, vv = 0.0f;
      const bool ok = (g < 2 || !last0) &&
                      pt_walk::mt_test(tri, 0, o, d, tb, tt, uu, vv);
      pt_walk::tri_quad(ok, tt, uu, vv, __float_as_int(q2.y), g, gmask,
                        shift, tb, ub, vb, ib);
      ptr = last0 || last1 ? lret : ptr + 8;
    } else {
      // a first visit, or a return the cache does not hold: every cached
      // row lies below it, so the ring is emptied; the row goes on top
      if (ptr & 3) cnt = 0;
      top = (top + 1) & (K - 1);
      cnt = min(cnt + 1, K);
#pragma unroll
      for (int j = 0; j < TAGS; ++j)
        if (g + G * j == top) tag[j] = ptr >> 2;
      __syncwarp(gmask);
      cache[top][g] = q0;
      cache[top][g + G] = q1;
      __syncwarp(gmask);
      ptr = node_step(reinterpret_cast<const float*>(cache[top]),
                      reinterpret_cast<const int*>(cache[top]), ptr, g,
                      gmask, shift, o, inv_d, tb, node_end4, lret);
    }
    while (ptr < node_end4 && (ptr & 3) != 0) {
      unsigned hm = 0;  // bit s: slot s holds the row
#pragma unroll
      for (int j = 0; j < TAGS; ++j) {
        const int s = g + G * j;
        const bool mine =
            ((top - s) & (K - 1)) < cnt && tag[j] == (ptr >> 2);
        hm |= ((__ballot_sync(gmask, mine) >> shift) & 0xFu) << (G * j);
      }
      if (hm == 0) break;  // the next iteration loads it
      const int s = __ffs(hm) - 1;
      cnt -= (top - s) & (K - 1);
      top = s;
      ptr = node_step(reinterpret_cast<const float*>(cache[top]),
                      reinterpret_cast<const int*>(cache[top]), ptr, g,
                      gmask, shift, o, inv_d, tb, node_end4, lret);
    }
  }
  if (g == 0) {
    t_out[i] = tb;
    u_out[i] = ub;
    v_out[i] = vb;
    idx_out[i] = ib;
    hit_out[i] = tb < t_lim;
  }
  const unsigned n_rays =
      __reduce_add_sync(rays_mask, g == 0 && walked ? 1u : 0u);
  const unsigned n_loads = __reduce_add_sync(rays_mask, g == 0 ? loads : 0u);
  if (lane == __ffs(rays_mask) - 1) {
    atomicAdd(counts, (unsigned long long)n_rays);
    atomicAdd(counts + 1, (unsigned long long)n_loads);
  }
}

}  // namespace

extern "C" {

// table (rows, 32) f32; org, dir (n, 3) f32; t_max0 (n,) f32; active (n,)
// bool; t, u, v (n,) f32, idx (n,) int32, hit (n,) bool; counts (2,) int64
// (the rays walked and their table loads, added to); all device
// pointers. node_end4 = 4 * node_end, done = 4 * (rows - 1); lanes_per_ray
// must be 4. Returns the cudaError_t of the launch.
int pt_bvh4_walk(const float* table, int node_end4, int stride, int done,
                 const float* org, const float* dir, const float* t_max0,
                 const uint8_t* active, float* t, float* u, float* v,
                 int* idx, uint8_t* hit, long long* counts, int n,
                 int lanes_per_ray, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (lanes_per_ray != G) return (int)cudaErrorInvalidValue;
  bvh4_walk_kernel<<<(n + BLOCK / G - 1) / (BLOCK / G), BLOCK, 0,
                     (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(table), node_end4, stride, done, org,
      dir, t_max0, active, t, u, v, idx, hit,
      reinterpret_cast<unsigned long long*>(counts), n);
  return (int)cudaGetLastError();
}

// K, for the wrapper to hold against the plain emulation's.
int pt_bvh4_cache_rows(void) { return K; }

}  // extern "C"
