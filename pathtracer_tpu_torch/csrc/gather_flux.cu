// PPM cone-filter photon gather over raster-grid ranges, for Hopper
// (sm_90a).
//
// Replaces: pathtracer_tpu/ops/pallas/gather_kernel.py:gather_flux_pallas
// (_kernel). The plain PyTorch version is
// ops/cuda/gather_kernel.py:gather_flux_plain, and the output equals it
// exactly. No caller renders through it: the photon mapper gathers with
// csrc/gather_chunks.cu.
//
// Input: photons sorted by raster cell key (build_photon_grid_morton), so
// each (dy, dz) row of a hit's 3x3x3 cell neighbourhood is one contiguous
// range [s, e) of the (16, Np_pad) photon table; query_tables gives every
// hit its 9 ranges (empty for a hit that is inactive or off the grid).
//
// Bound on this card: FP32 issue over the hit-photon pairs of the ranges
// (cell / r of 1 to 3 makes that 27 cells of photons for a sphere of
// radius r), each counted where a walk must take it: 8 operations for
// d^2 of a pair outside r, 13 with n . n_p for one inside r that faces
// away, 22 for one that adds (gather_kernel.raster_pair_counts counts
// them); the photons' 36 bytes are read from L1/L2 many times but from
// device memory about once.
//
// What set the time (chip_smoke.py phase 6, cornell iteration 1): the
// longest lanes hold 11,499 pairs, and the block of the longest lane took
// 1.29 of the launch's 1.80 ms alone, ~200 cycles a pair: one lane's chain
// of loads, compare, branch and adds, with few other warps left to hide it.
// The lanes of a warp hold nearly the same ranges (1.06-1.15 distinct
// ranges a warp and offset; their pairs are 0.99 of 32 x the warp's
// longest lane), so their loads of one position are one broadcast.
//
// Design. Each lane still walks its own 9 ranges, offset 0..8 and then
// photon index ascending, adding (1 - d/r) * flux where d^2 < r^2 and
// n . n_p > 1e-3, as the plain version does; what changed is how a warp
// feeds and schedules that walk.
//  - Staging: per offset, each warp copies TILE positions at a time of the
//    9 photon planes into shared memory with cp.async (csrc/cp_async.cuh;
//    coalesced, 4 bytes a copy) as 48-byte records, double-buffered: the
//    next tile is in flight while the lanes walk the current one. A tile
//    starts at the first position that some lane still needs (a warp
//    minimum), so the gap between two lanes' ranges on different grid rows
//    is not staged.
//  - Heavy warps: a warp whose longest lane holds more than heavy_min
//    pairs (gather_kernel.HEAVY, 4,096) walks its tiles in batches of
//    BATCH positions, stage by stage over the batch (loads, distances,
//    square roots, contributions) and only then
//    adds the batch in order. A pair that fails the tests, or lies past
//    the range, adds +0.0, which leaves the sum's bits as they are: a sum
//    that starts at +0.0 is never -0.0 (x + y is -0.0 only if both are),
//    and s + 0.0 == s for every other s, NaN and inf included. The square
//    root is sqrt_rn.cuh's branch-free copy of sqrtf, so that the batch's
//    pairs overlap instead of running one after another.
//  - Light warps keep the per-pair branch (most pairs fail d^2 < r^2 and
//    skip the root), which issues fewer instructions per pair.
//  - Order: the wrapper sorts the warps by their longest lane, longest
//    first (warp_order), so the heavy warps start with the launch instead
//    of in a late wave. Each hit's sum does not depend on when it runs.
//
// The TPU kernel streamed each 1024-hit block's union range through SMEM
// in double-buffered 128-photon DMAs and broadcast every photon to all
// lanes, testing `s <= idx < e` per lane: a photon outside a lane's range
// added an exact +0.0, so its per-lane sums are exactly these, in this
// order. Per warp instead of per block, the union is nearly each lane's
// own range (the JAX code measured ~89% of a block's streamed chunks
// dead). Built with -fmad=false and IEEE sqrt/division, so every lane
// rounds as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "sqrt_rn.cuh"

namespace {

constexpr int THREADS = 64;  // two warps, each on its own 32 hits
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;  // photon positions a warp stages at once
constexpr int REC = 12;  // floats a staged photon: [p.xyz n.x][n.yz f.xy][f.z]
constexpr int BATCH = 8;  // positions a heavy warp's lanes overlap
constexpr int N_OFF = 9;  // (dy, dz) rows of the 3x3x3 neighbourhood
constexpr int N_COMP = 9;  // photon planes read: pos3, nrm3, flux3
constexpr int NONE = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NDOT_MIN = 0x1.0624dep-10f;  // np.float32(1e-3)

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) v = min(v, __shfl_xor_sync(FULL, v, k));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) v = max(v, __shfl_xor_sync(FULL, v, k));
  return v;
}

// The first position at or after `from` that a lane with range [s, e)
// still needs, or NONE.
__device__ __forceinline__ int needed(int from, int s, int e) {
  const int p = max(from, s);
  return p < e ? p : NONE;
}

// Positions [base, base + TILE) of the 9 photon planes into buf as REC-float
// records (a lane copies positions base + lane and base + lane + 32);
// positions past the table are left as they are: no range reaches them.
__device__ __forceinline__ void stage(float* buf,
                                      const float* __restrict__ photons,
                                      size_t np, int base, int lane) {
#pragma unroll
  for (int h = 0; h < TILE; h += 32) {
    const size_t j = (size_t)base + h + lane;
    if (j < np) {
#pragma unroll
      for (int c = 0; c < N_COMP; ++c)
        pt_async::copy4(&buf[(h + lane) * REC + c], photons + c * np + j);
    }
  }
}

struct Hit {
  float x, y, z, nx, ny, nz, r2, inv_r;
};

// Positions [k0, k1) of tile t, one pair at a time.
__device__ __forceinline__ void walk_pairs(const float* t, int k0, int k1,
                                           const Hit& h, float& a0,
                                           float& a1, float& a2) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 u = *(const float4*)&t[REC * k];
    const float4 v = *(const float4*)&t[REC * k + 4];
    const float dx = u.x - h.x;
    const float dy = u.y - h.y;
    const float dz = u.z - h.z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float ndot = u.w * h.nx + v.x * h.ny + v.y * h.nz;
    if (d2 < h.r2 && ndot > NDOT_MIN) {
      const float w = 1.0f - sqrtf(d2) * h.inv_r;
      a0 = a0 + w * v.z;
      a1 = a1 + w * v.w;
      a2 = a2 + w * t[REC * k + 8];
    }
  }
}

// Positions [k0, k1) of tile t in batches of BATCH, stage by stage; a
// position past k1 or a pair that fails the tests adds +0.0.
__device__ __forceinline__ void walk_batches(const float* t, int k0, int k1,
                                             const Hit& h, float& a0,
                                             float& a1, float& a2) {
  for (int kb = k0; kb < k1; kb += BATCH) {
    float4 u[BATCH], v[BATCH];
    float f2[BATCH], d2[BATCH], nd[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int k = min(kb + b, k1 - 1);
      u[b] = *(const float4*)&t[REC * k];
      v[b] = *(const float4*)&t[REC * k + 4];
      f2[b] = t[REC * k + 8];
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const float dx = u[b].x - h.x;
      const float dy = u[b].y - h.y;
      const float dz = u[b].z - h.z;
      d2[b] = dx * dx + dy * dy + dz * dz;
      nd[b] = u[b].w * h.nx + v[b].x * h.ny + v[b].y * h.nz;
    }
    float c0[BATCH], c1[BATCH], c2[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const float w = 1.0f - pt_sqrt::sqrt_nonneg(d2[b]) * h.inv_r;
      const bool ok = kb + b < k1 && d2[b] < h.r2 && nd[b] > NDOT_MIN;
      c0[b] = ok ? w * v[b].z : 0.0f;
      c1[b] = ok ? w * v[b].w : 0.0f;
      c2[b] = ok ? w * f2[b] : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      a0 = a0 + c0[b];
      a1 = a1 + c1[b];
      a2 = a2 + c2[b];
    }
  }
}

// (a minimum of 1 CTA an SM leaves ptxas the registers to keep a batch's
// loads in flight: at 56 registers instead of 69 the launch took 1.20 ms
// instead of 0.98 on cornell iteration 1, NVIDIA H100 80GB HBM3)
__global__ void __launch_bounds__(THREADS, 1)
    gather_flux_kernel(const float* __restrict__ hits,
                       const int* __restrict__ s_tab,
                       const int* __restrict__ e_tab,
                       const float* __restrict__ photons, int np_pad, float r,
                       const int* __restrict__ warp_order, int heavy_min,
                       float* __restrict__ out, int n) {
  __shared__ __align__(16) float tiles[WARPS][2][REC * TILE];
  const int lane = threadIdx.x & 31;
  float(*const buf)[REC * TILE] = tiles[threadIdx.x >> 5];
  // n is a multiple of 1024: every warp has 32 hits
  const size_t i =
      (size_t)warp_order[blockIdx.x * WARPS + (threadIdx.x >> 5)] * 32 + lane;
  const Hit h = {hits[i],
                 hits[n + i],
                 hits[2 * (size_t)n + i],
                 hits[3 * (size_t)n + i],
                 hits[4 * (size_t)n + i],
                 hits[5 * (size_t)n + i],
                 r * r,
                 1.0f / r};
  const size_t np = (size_t)np_pad;
  int len = 0;
  for (int o = 0; o < N_OFF; ++o)
    len += max(e_tab[o * (size_t)n + i] - s_tab[o * (size_t)n + i], 0);
  const bool heavy = warp_max(len) > heavy_min;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int o = 0; o < N_OFF; ++o) {
    const int s = s_tab[o * (size_t)n + i];
    const int e = e_tab[o * (size_t)n + i];
    int cur = warp_min(needed(s, s, e));
    if (cur == NONE) continue;  // warp-uniform
    int st = 0;
    stage(buf[0], photons, np, cur, lane);
    pt_async::commit();
    while (cur != NONE) {
      const int nxt = warp_min(needed(cur + TILE, s, e));
      if (nxt != NONE) stage(buf[st ^ 1], photons, np, nxt, lane);
      pt_async::commit();
      pt_async::wait<1>();
      __syncwarp();  // every lane's copies of tile `cur` have landed
      const int k0 = max(s - cur, 0), k1 = min(e - cur, TILE);
      if (heavy)
        walk_batches(buf[st], k0, k1, h, a0, a1, a2);
      else
        walk_pairs(buf[st], k0, k1, h, a0, a1, a2);
      __syncwarp();  // tile `cur` is read before it is staged over
      cur = nxt;
      st ^= 1;
    }
  }
  out[i] = a0;
  out[n + i] = a1;
  out[2 * (size_t)n + i] = a2;
}

}  // namespace

extern "C" {

// hits (6, n) [point3, normal3]; s_tab, e_tab (9, n) int32; photons
// (16, np_pad); warp_order (n / 32,) int32, a permutation of the 32-hit
// groups; heavy_min, the pairs of a warp's longest lane above which it
// walks in batches; out (3, n); all device pointers, n a multiple of 1024.
// Returns the cudaError_t.
int pt_gather_flux(const float* hits, const int* s_tab, const int* e_tab,
                   const float* photons, int np_pad, float r,
                   const int* warp_order, int heavy_min, float* out, int n,
                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  gather_flux_kernel<<<n / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      hits, s_tab, e_tab, photons, np_pad, r, warp_order, heavy_min, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
