// Clustered nearest-hit ray/sphere-set intersection with a per-block
// bounding-sphere cull, for Hopper (sm_90a).
//
// Replaces: pathtracer_tpu/ops/pallas/sphere_kernel.py:intersect_clustered_pallas
// (_kernel_clustered). The plain PyTorch version is
// ops/cuda/sphere_kernel.py:intersect_clustered_plain, and the output
// equals it exactly; ops/cuda/sphere_kernel.py:intersect_clustered_walk_plain
// emulates this kernel's walk (the block mask, the warp skip, the real
// slots) and counts its work. No caller renders through it: it is the
// clustered yardstick of csrc/intersect_spheres.cu, whose contract it
// shares.
//
// What it computes. For lane i of 1024-ray block b, cluster c is tested iff
// some live lane of b passes the JAX cull predicate on c (the bounding
// sphere [C, r^2] of the (4, K) cluster table: perp^2 <= r^2 or the origin
// inside, and fb >= -sqrt(r^2 a)); every lane of b, dead ones too, then
// takes the first least candidate over the tested clusters' slots in
// ascending slot order, a candidate being the pair's a*t key where
// disc >= 0 and at >= 0 and BIG elsewhere, under a strict `<` from
// (BIG, 0). The winner's slot goes out through perm.
//
// Design, three steps, each bit-neutral by the argument given below:
// 1. Real slots only. Cluster c's slots c*16 + [0, count) are walked, where
//    slot c*16 + count and every later one is a pad word (0, 0, 0, -BIG)
//    (ClusterWalk.runs, from the host's sphere_kernel.cluster_walk, once per
//    table set). Only real words are staged in shared memory, compacted.
// 2. One block decision. Each lane evaluates the JAX predicate (the same
//    float operations as before, sqrtf(r^2 a) included) on every cluster,
//    collects 32 clusters' results in a word, and one OR-reduction per
//    word (__reduce_or_sync) makes them its warp's; the warps OR their
//    words into a shared bitmask of ceil(K / 32) words, and one barrier
//    publishes it. A CTA holds CTA = 256 threads, so the 4 CTAs of one
//    1024-ray block form a thread-block cluster and OR their masks through
//    distributed shared memory.
// 3. A warp-level skip. Inside each surviving cluster (ascending order) a
//    warp enters only if some lane, live or dead, may take a pair there: a
//    conservative test on the cluster's grown bound (ClusterWalk.bounds:
//    built from its real spheres, as the sphere hierarchy's nodes are),
//    BATCH tests issued together and one OR-reduction per mask word.
//    Entered clusters run the pair test, with an early reject that skips
//    the square root.
//
// Proof 1: a pad is never taken, on any lane. Pad words have c = (+-0,
// +-0, +-0) and A = -BIG, so bp = -od and g = fl(-BIG - oq) exactly the
// float pair test's values. If o or d holds a NaN or an infinity, a
// product 0 * inf or the NaN reaches g or bp, and so disc: NaN is never
// taken. Otherwise g <= -BIG < 0. If BIG + oq overflows, g = -inf and disc
// is -inf or NaN. Else a candidate needs disc >= 0, i.e. y = fl(fl(bp^2)
// inv_a) >= -g >= BIG. If y = inf (inv_a = inf, or bp^2 huge), disc is
// +inf or NaN and sq = sqrtf(a disc) is inf or NaN (a = 0), so at = bp - sq
// is -inf or NaN: not taken. A finite y >= BIG needs inv_a finite, so
// a >= 2^-128, and then the rounding of a (subnormal terms included) is
// within 16 u of |d|^2 (u = 2^-24); by Cauchy-Schwarz, od^2 <= |o|^2 |d|^2,
// so y <= oq (1 + 40 u), which is below fl(BIG + oq) >= (BIG + oq)(1 - u)
// for every oq <= FLT_MAX. So disc < 0 for every finite lane with a finite
// g: no lane, dead, NaN, far or of any |d|, takes a pad (CPU test:
// tests/test_torch_clustered_walk.py, no_pad_is_taken).
//
// Proof 2: the block decision is unchanged. Each lane evaluates the same
// predicate with the same operations, in the same order, under
// -fmad=false; an OR over the 1024 lanes does not depend on the order in
// which the warps' words arrive. The predicate's last term, fb >=
// -sqrtf(x) with x = fl(r^2 a), is read as x >= 0 where fb >= 0: sqrtf(x)
// is +0, -0, positive or inf for x >= 0 (x = -0 included), so -sqrtf(x) <=
// +0 <= fb, and NaN for x < 0 or NaN, where x >= 0 fails too; where fb is
// NaN both are false; only lanes with fb < 0 on a near cluster take the
// square root. A block with no live lane sets no bit and gives
// (BIG, perm[0]) everywhere, as before (CPU test: predicate_rewrite).
//
// Proof 3: the warp skip drops no pair that would be taken. Let u = 2^-24,
// m = CULL_SLOPE = 2^-7 (m^2 = 1024 u), o, d the lane's ray, |d|^2 =
// 1 + delta, and for a real sphere (c, A) of the cluster r^2 = max(A +
// |c|^2, 0) and L = |c| + r + |o|. The pair test here is bp = c.d - o.d,
// g = A + 2 c.o - |o|^2, disc = g + bp^2 inv_a, sq = sqrtf(a disc). Every
// operation rounded once: bp is within 4.1 u L of (c - o).d; g within
// 5 u L^2 of r^2 - |c - o|^2 (or below it, when A + |c|^2 < 0); y =
// bp^2 inv_a within 14.3 u L^2 of ((c - o).d)^2 / |d|^2 (8.2 from bp, 6
// from rounding bp^2, 1/a with a's own 3 u, and the product); the sum 2 u
// L^2 more. So disc is within 22 u L^2 of r^2 - p^2, p the distance from c
// to the ray's line: exactly, with no delta term, since the pair divides
// by a. A taken pair needs disc >= 0, so p^2 <= r^2 + 22 u L^2, and
// at >= 0, so bp >= 0 (if bp < 0, inside_pos fails and at = bp - sq < 0).
// The bound (C, R) holds each real sphere (|c - C| + r <= R, so L <= L_C =
// |C| + R + |o|) and the host stores RL >= R + m (|C| + R), rounded up, at
// least 2^-60 (which lifts the margins over every subnormal rounding).
// The lane's test is the hierarchy's (csrc/pt_bounce.cuh): w = C - o,
// b = w.d, q = |w|^2, lim = RL + m sqrtf(oq) >= (R + m L_C)(1 - 3.6 u), and
// it rejects only if q - b^2 > lim^2 or b < -lim. Its q - b^2 is within
// (16 u + |delta|) L_C^2 of the exact p_C^2, p_C the distance from C to the
// line, and p_C <= p + |c - C| <= R + sqrt(22 u) L_C for a taken pair.
// With |delta| <= DIR_TOL + 4 u = 132 u, the first compare passes while
// (R + sqrt(22 u) L_C)^2 + (16 u + 132 u) L_C^2 <= (R + m L_C)^2
// (1 - 8.2 u): since m > sqrt(22 u) (2^-7 against 1.17 * 2^-10) and R <=
// L_C, it holds with 1024 u - (22 + 148 + 8.3) u = 845 u of m^2 to spare;
// the hierarchy's pair form needed 2 |delta| more, this one none, so 2^-7
// stays. The second: (c - o).d >= -4.1 u L gives b >= -(R (1 + 70 u) +
// 8.2 u L_C) > -lim by a margin of ~m L_C. Lanes the proof does not cover
// vote to enter every cluster: |a - 1| > DIR_TOL, |o|^2 >= ORG_Q_MAX =
// 2^100, or NaN (CPU test: uncovered lanes). Clusters holding a sphere
// that is not finite or reaches past FAR = 2^50 get RL = inf, which every
// lane enters.
// Surviving clusters are visited in ascending order, slots in ascending
// order, with the strict `<`: the result is the plain version's first
// least candidate, since every skipped pair's candidate is BIG.
// The early reject: a pair with !(bp >= 0) or !(disc >= 0) has candidate
// BIG (at < 0 or NaN), so skipping its sqrt and compare changes no bit.
//
// Bound on this card: FP32 issue. The block decision costs every lane of a
// live warp ~28 instructions per cluster (K = 178 on shirley; most of the
// time on an H100), whatever the warp's lanes hit; the walk one
// ~22-instruction bound test per surviving cluster (70 of 178 a block on
// shirley's bounce-1 rays) and ~25 per real pair of the clusters its warp
// enters.
// CTAs of 256 threads let other CTAs fill an SM while a block's slowest
// warp finishes its walk (1024-thread CTAs read slower, 512 and 128 within
// a few percent: PERF.md, §6). Left for later PRs: a two-level cluster tree,
// whose node test would prove the predicate false for many clusters at
// once (the block decision's cost is per cluster); packing a block's live
// lanes into full warps for the block decision (24% of the lanes of
// shirley's bounce-1 rays are dead).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int RAY_BLOCK = 1024;
constexpr int CLUSTER = 16;  // slots per cluster of the sphere table
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 0x1.c363ccp+127f;  // np.float32(3.0e38)
// the warp skip's margin and its lanes' limits
// (ops/cuda/sphere_kernel.py: CULL_SLOPE, DIR_TOL, ORG_Q_MAX)
constexpr float CULL_SLOPE = 0x1p-7f;
constexpr float DIR_TOL = 0x1p-17f;
constexpr float ORG_Q_MAX = 0x1p100f;
constexpr int BATCH = 4;  // grown-bound tests issued together in the walk
constexpr int CTA = 256;  // threads per CTA
constexpr int PARTS = RAY_BLOCK / CTA;  // CTAs (one cluster) per ray block

// Shared memory of one CTA: the cull table and the grown bounds (float4 per
// cluster), the real sphere words (float4 each), the runs (int2 per
// cluster), then the mask: this CTA's words, then the block's.
inline size_t smem_bytes(int n_clusters, int n_real) {
  const size_t words = (n_clusters + 31) / 32;
  return (2 * sizeof(float4) + sizeof(int2)) * (size_t)n_clusters +
         sizeof(float4) * (size_t)n_real + 2 * sizeof(unsigned) * words;
}

__global__ void __launch_bounds__(CTA, PARTS)
    intersect_clustered_kernel(const float* __restrict__ sph,
                               const float* __restrict__ clus,
                               const float4* __restrict__ bounds,
                               const int2* __restrict__ runs, int n_clusters,
                               int n_real, const int* __restrict__ perm,
                               const float* __restrict__ org,
                               const float* __restrict__ dir,
                               const uint8_t* __restrict__ alive,
                               float* __restrict__ at_out,
                               int* __restrict__ idx_out,
                               float* __restrict__ inv_a_out) {
  extern __shared__ float4 smem[];
  const int k = n_clusters;
  const int n_words = (k + 31) / 32;
  const int n_slots = k * CLUSTER;
  float4* clus_s = smem;  // [cx, cy, cz, r^2] per cluster
  float4* bound_s = clus_s + k;  // [Cx, Cy, Cz, RL] per cluster
  float4* sph_s = bound_s + k;  // [cx, cy, cz, A] per real slot
  int2* run_s = reinterpret_cast<int2*>(sph_s + n_real);  // [first, count]
  unsigned* mask_s = reinterpret_cast<unsigned*>(run_s + k);
  for (int c = threadIdx.x; c < k; c += CTA) {
    clus_s[c] = make_float4(clus[c], clus[k + c], clus[2 * k + c],
                            clus[3 * k + c]);
    bound_s[c] = bounds[c];
    run_s[c] = runs[c];
  }
  for (int s = threadIdx.x; s < n_slots; s += CTA) {
    const int2 run = __ldg(runs + s / CLUSTER);
    const int j = s % CLUSTER;
    if (j < run.y)
      sph_s[run.x + j] = make_float4(sph[s], sph[n_slots + s],
                                     sph[2 * n_slots + s],
                                     sph[3 * n_slots + s]);
  }
  for (int w = threadIdx.x; w < n_words; w += CTA) mask_s[w] = 0u;

  const size_t i = (size_t)blockIdx.x * CTA + threadIdx.x;
  const float d0 = dir[3 * i], d1 = dir[3 * i + 1], d2 = dir[3 * i + 2];
  const float o0 = org[3 * i], o1 = org[3 * i + 1], o2 = org[3 * i + 2];
  const float a = d0 * d0 + d1 * d1 + d2 * d2;
  const float inv_a = 1.0f / a;
  inv_a_out[i] = inv_a;
  const bool live = alive[i] != 0;
  const float od = o0 * d0 + o1 * d1 + o2 * d2;
  const float oq = o0 * o0 + o1 * o1 + o2 * o2;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // the tables and the zeroed mask

  // 2. the block decision: bit c of the mask is set iff a live lane of this
  // CTA passes the JAX cull predicate on cluster c. A lane collects its
  // predicates of one word's 32 clusters in `mine`, one OR-reduction per
  // word makes them the warp's. The predicate's last term,
  // fb >= -sqrtf(r^2 a), is (r^2 a >= 0) where fb >= 0 (sqrtf is >= 0 or
  // -0 there, NaN below 0) and NaN where fb is; the lanes with fb < 0 on a
  // near cluster (`need`) take the square root after the word's loop.
  if (__any_sync(FULL, live)) {
    for (int w = 0; w < n_words; ++w) {
      const int c0 = w * 32;
      unsigned mine = 0u, need = 0u;
#pragma unroll 8
      for (int u = 0; u < 32; ++u) {
        const float4 c = clus_s[min(c0 + u, k - 1)];
        const float fx = c.x - o0, fy = c.y - o1, fz = c.z - o2;
        const float fb = fx * d0 + fy * d1 + fz * d2;
        const float fq = fx * fx + fy * fy + fz * fz;
        const float perp2 = fq - fb * fb * inv_a;
        const bool near = (perp2 <= c.w) || (fq <= c.w);
        mine |= (unsigned)(near && fb >= 0.0f && c.w * a >= 0.0f) << u;
        need |= (unsigned)(near && fb < 0.0f) << u;
      }
      if (c0 + 32 > k) need &= (1u << (k - c0)) - 1u;
      while (need != 0u) {
        const int u = __ffs(need) - 1;
        need &= need - 1u;
        const float4 c = clus_s[c0 + u];
        const float fx = c.x - o0, fy = c.y - o1, fz = c.z - o2;
        const float fb = fx * d0 + fy * d1 + fz * d2;
        mine |= (unsigned)(fb >= -sqrtf(c.w * a)) << u;
      }
      if (c0 + 32 > k) mine &= (1u << (k - c0)) - 1u;
      const unsigned word = __reduce_or_sync(FULL, live ? mine : 0u);
      if (lane == 0 && word != 0u) atomicOr(mask_s + w, word);
    }
  }
  // OR the masks of the block's PARTS CTAs
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  for (int w = threadIdx.x; w < n_words; w += CTA) {
    unsigned v = 0u;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) v |= cl.map_shared_rank(mask_s, p)[w];
    mask_s[n_words + w] = v;
  }
  cl.sync();  // every remote read is done; the block's words published
  const unsigned* block_mask = mask_s + n_words;

  // 3. the walk, one mask word at a time: the lane's grown-bound tests of
  // the word's surviving clusters, BATCH at once, one OR-reduction for the
  // warp's entered set, then the real slots of each entered cluster in
  // ascending order
  const bool every = !(fabsf(a - 1.0f) <= DIR_TOL) || !(oq <= ORG_Q_MAX);
  const float mon = CULL_SLOPE * sqrtf(oq);
  float best_at = BIG;
  int best_idx = 0;
  for (int w = 0; w < n_words; ++w) {
    unsigned todo = block_mask[w];
    unsigned mine = 0u;
    while (todo != 0u) {
#pragma unroll
      for (int v = 0; v < BATCH; ++v) {
        const int u = __ffs(todo) - 1;  // -1 once the word is done
        todo &= todo - 1u;
        const float4 nb = bound_s[w * 32 + max(u, 0)];
        const float w0 = nb.x - o0, w1 = nb.y - o1, w2 = nb.z - o2;
        const float b = w0 * d0 + w1 * d1 + w2 * d2;
        const float q = w0 * w0 + w1 * w1 + w2 * w2;
        const float lim = nb.w + mon;
        const bool may = every | (!(q - b * b > lim * lim) & !(b < -lim));
        mine |= (unsigned)(may && u >= 0) << max(u, 0);
      }
    }
    unsigned enter = __reduce_or_sync(FULL, mine);
    while (enter != 0u) {
      const int c = w * 32 + __ffs(enter) - 1;
      enter &= enter - 1u;
      const int2 run = run_s[c];
      for (int j = 0; j < run.y; ++j) {
        const float4 sp = sph_s[run.x + j];
        const float bp = sp.x * d0 + sp.y * d1 + sp.z * d2 - od;
        const float g = sp.w + 2.0f * (sp.x * o0 + sp.y * o1 + sp.z * o2) - oq;
        const float disc = g + bp * bp * inv_a;
        if (!(bp >= 0.0f) || !(disc >= 0.0f)) continue;  // early reject
        const float sq = sqrtf(a * disc);
        const float at = bp + ((g >= 0.0f) ? sq : -sq);
        if (at >= 0.0f && at < best_at) {
          best_at = at;
          best_idx = c * CLUSTER + j;
        }
      }
    }
  }
  at_out[i] = best_at;
  idx_out[i] = perm[best_idx];
}

}  // namespace

extern "C" {

// sph (4, 16 K), clus (4, K), perm (16 K,) int32; bounds (K,) float4 and
// runs (K,) int2 of sphere_kernel.cluster_walk, whose counts sum to n_real;
// org, dir (n, 3); alive (n,) bool; at, idx, inv_a (n,); all device
// pointers, n a multiple of 1024. Returns the cudaError_t.
int pt_intersect_clustered(const float* sph, const float* clus,
                           int n_clusters, const void* bounds,
                           const void* runs, int n_real, const int* perm,
                           const float* org, const float* dir,
                           const uint8_t* alive, float* at, int* idx,
                           float* inv_a, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes(n_clusters, n_real);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        intersect_clustered_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n / CTA);
  cfg.blockDim = dim3(CTA);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = PARTS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, intersect_clustered_kernel, sph, clus,
      static_cast<const float4*>(bounds), static_cast<const int2*>(runs),
      n_clusters, n_real, perm, org, dir, alive, at, idx, inv_a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
