// PPM cone-filter photon gather over per-block chunk lists, for Hopper
// (sm_90a).
//
// Replaces: pathtracer_tpu/ops/pallas/gather_kernel.py:gather_flux_chunks_pallas
// (_kernel_chunks). The plain PyTorch version is
// ops/cuda/gather_kernel.py:gather_flux_chunks_plain, and the output equals
// it exactly.
//
// Design: a block's list (from block_chunk_lists, torch glue) is cut into
// segments of `seg` list positions, and each (block, segment) is a work
// item; item_start (an exclusive cumsum of ceil(count / seg) per block)
// numbers them, block-major. The lists' lengths vary 10-fold and more
// (cornell: mean 31, longest 438 chunks), so one CTA per block left the
// card waiting on the longest list; items of at most `seg` chunks spread
// it over the SMs.
//
// Pass 1 (gather_chunks_items_kernel): four CTAs of 256 threads per item,
// each a quarter of the block's 1024 Morton-sorted hits, one thread per
// hit.
// Each listed 128-photon chunk (9 planes: pos, normal, flux; 4.6 KB) and
// its four 32-photon sub-chunk boxes are staged into shared memory with
// cp.async, double-buffered: the next chunk's copy runs while the CTA
// walks the current one. A thread sums its segment into a partial that
// starts at +0.0, in the JAX kernel's order (list position, then
// sub-chunk, then photon): w = 1 - sqrtf(d2) * (1/r) where d2 < r^2 and
// n . n_p > 1e-3, else 0, times the photon's flux. The partials go to
// partial[item][3][1024].
//
// Per-warp skip: a warp walks a listed sub-chunk (mask bit set) only if
// the sub-chunk's box meets the box of the warp's active hits grown by the
// padded radius r_pad. The list itself was culled against the whole
// block's box; 32 Morton-adjacent hits cover much less. Skipping is
// bit-neutral for the reason the block cull relies on
// (pathtracer_tpu/ops/pallas/gather_kernel.py:24-26): every photon of a
// skipped sub-chunk is more than r from every active hit of the warp, so
// it would add w * flux = an exact +0.0 to an accumulator that is never
// -0.0. The test is warp-uniform, so no lane diverges on it.
//
// Pass 2 (gather_chunks_combine_kernel): one thread per hit adds its
// block's partials in segment order, from +0.0; inactive hits, and blocks
// with an empty list, write 0. No float atomics: the result does not
// depend on the grid, the SM count or the order in which CTAs finish. When
// a list is at most `seg` long the sum is the unsplit one, bit for bit
// (0 + p = p).
// Built with -fmad=false and IEEE sqrt/division, so every lane rounds as
// the plain version does.
//
// Bound on this card: FP32 issue and shared-memory reads, ~22 operations
// a hit-photon pair of the walked sub-chunks; each chunk costs the CTA two
// barriers. Left for later PRs: a finer hit sort, and more hits per thread
// (one shared-memory broadcast feeds one pair today).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int BLOCK = 1024;  // hits per list block
constexpr int CTA = 256;  // threads per CTA: a quarter of a block
constexpr int QUARTERS = BLOCK / CTA;
constexpr int CHB = 128;  // photons per chunk
constexpr int SUB = 32;  // photons per sub-chunk
constexpr int N_SUBS = CHB / SUB;
constexpr int PLANES = 9;  // pos, normal, flux
constexpr int PLANE_VECS = CHB / 4;  // 16-byte pieces of a chunk's plane
constexpr int PHOTON_VECS = PLANES * PLANE_VECS;
constexpr int STAGE_VECS = PHOTON_VECS + 6;  // + the 6 box planes of 4 subs
constexpr int MASK_SHIFT = 24;
constexpr uint32_t CHUNK_MASK = (1u << MASK_SHIFT) - 1u;
constexpr float NDOT_MIN = 0x1.0624dep-10f;  // np.float32(1e-3)
constexpr float BIG = 0x1.c363ccp+127f;  // np.float32(3.0e38)

struct __align__(16) Stage {
  float ph[PLANES][CHB];
  float box[6][N_SUBS];  // lo3, hi3 of the chunk's sub-chunks
};

// Issue the copies of chunk `chunk` into `st` as one cp.async group.
__device__ __forceinline__ void stage_chunk(Stage& st,
                                            const float* __restrict__ photons,
                                            int np_pad,
                                            const float* __restrict__ sbox,
                                            int n_sub, uint32_t chunk) {
  for (int e = threadIdx.x; e < STAGE_VECS; e += CTA) {
    if (e < PHOTON_VECS) {
      const int p = e / PLANE_VECS, v = e % PLANE_VECS;
      pt_async::copy16(&st.ph[p][4 * v], photons + (size_t)p * np_pad +
                                              (size_t)chunk * CHB + 4 * v);
    } else {
      const int p = e - PHOTON_VECS;
      pt_async::copy16(&st.box[p][0],
                       sbox + (size_t)p * n_sub + (size_t)chunk * N_SUBS);
    }
  }
  pt_async::commit();
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(CTA)
    gather_chunks_items_kernel(const float* __restrict__ hits,
                               const int* __restrict__ lists,
                               const int* __restrict__ counts,
                               const int* __restrict__ item_start,
                               int n_blocks, int list_stride,
                               const float* __restrict__ photons, int np_pad,
                               const float* __restrict__ sbox, float r,
                               float r_pad, int seg,
                               float* __restrict__ partial, int n) {
  __shared__ Stage st[2];
  const int item = blockIdx.x / QUARTERS;
  // the block of the item: the last b with item_start[b] <= item
  int lo = 0, hi = n_blocks;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (item_start[mid] <= item) lo = mid; else hi = mid;
  }
  const int b = lo;
  const int k0 = (item - item_start[b]) * seg;
  const int k1 = min(k0 + seg, counts[b]);
  const int h = (blockIdx.x % QUARTERS) * CTA + threadIdx.x;
  const size_t i = (size_t)b * BLOCK + h;
  const float x = hits[i], y = hits[n + i], z = hits[2 * (size_t)n + i];
  const float nx = hits[3 * (size_t)n + i], ny = hits[4 * (size_t)n + i],
              nz = hits[5 * (size_t)n + i];
  const bool act = hits[6 * (size_t)n + i] > 0.0f;
  // the warp's active-hit box grown by r_pad, as block_chunk_lists grows
  // the block's (an all-inactive warp's box is empty and meets nothing)
  const float wlo0 = warp_min(act ? x : BIG) - r_pad;
  const float wlo1 = warp_min(act ? y : BIG) - r_pad;
  const float wlo2 = warp_min(act ? z : BIG) - r_pad;
  const float whi0 = warp_max(act ? x : -BIG) + r_pad;
  const float whi1 = warp_max(act ? y : -BIG) + r_pad;
  const float whi2 = warp_max(act ? z : -BIG) + r_pad;
  const int* list = lists + (size_t)b * list_stride;
  const int n_sub = np_pad / SUB;
  const float inv_r = 1.0f / r;
  const float r2 = r * r;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  if (k0 < k1) stage_chunk(st[0], photons, np_pad, sbox, n_sub,
                           (uint32_t)list[k0] & CHUNK_MASK);
  for (int k = k0; k < k1; ++k) {
    const int buf = (k - k0) & 1;
    if (k + 1 < k1) {
      stage_chunk(st[buf ^ 1], photons, np_pad, sbox, n_sub,
                  (uint32_t)list[k + 1] & CHUNK_MASK);
      pt_async::wait<1>();
    } else {
      pt_async::wait<0>();
    }
    __syncthreads();  // chunk k has landed for every thread
    const Stage& c = st[buf];
    const uint32_t mask = (uint32_t)list[k] >> MASK_SHIFT;
    for (int t = 0; t < N_SUBS; ++t) {
      if (!((mask >> t) & 1u)) continue;
      if (!(c.box[3][t] >= wlo0 && c.box[0][t] <= whi0 &&
            c.box[4][t] >= wlo1 && c.box[1][t] <= whi1 &&
            c.box[5][t] >= wlo2 && c.box[2][t] <= whi2))
        continue;  // per-warp skip: adds only +0.0 (see the header)
      for (int j = t * SUB; j < (t + 1) * SUB; ++j) {
        const float dx = c.ph[0][j] - x;
        const float dy = c.ph[1][j] - y;
        const float dz = c.ph[2][j] - z;
        const float d2 = dx * dx + dy * dy + dz * dz;
        const float ndot = c.ph[3][j] * nx + c.ph[4][j] * ny + c.ph[5][j] * nz;
        const bool ok = (d2 < r2) && (ndot > NDOT_MIN);
        const float wf = ok ? 1.0f - sqrtf(d2) * inv_r : 0.0f;
        a0 = a0 + wf * c.ph[6][j];
        a1 = a1 + wf * c.ph[7][j];
        a2 = a2 + wf * c.ph[8][j];
      }
    }
    __syncthreads();  // chunk k is consumed before its buffer is refilled
  }
  float* p = partial + (size_t)item * 3 * BLOCK + h;
  p[0] = a0;
  p[BLOCK] = a1;
  p[2 * BLOCK] = a2;
}

__global__ void __launch_bounds__(CTA)
    gather_chunks_combine_kernel(const float* __restrict__ hits,
                          const int* __restrict__ item_start,
                          const float* __restrict__ partial,
                          float* __restrict__ out, int n) {
  const int i = blockIdx.x * CTA + threadIdx.x;
  if (i >= n) return;
  const int b = i / BLOCK, h = i % BLOCK;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  const int end = item_start[b + 1];
  for (int it = item_start[b]; it < end; ++it) {
    const float* p = partial + (size_t)it * 3 * BLOCK + h;
    a0 = a0 + p[0];
    a1 = a1 + p[BLOCK];
    a2 = a2 + p[2 * BLOCK];
  }
  const bool act = hits[6 * (size_t)n + i] > 0.0f;
  out[i] = act ? a0 : 0.0f;
  out[n + i] = act ? a1 : 0.0f;
  out[2 * (size_t)n + i] = act ? a2 : 0.0f;
}

}  // namespace

extern "C" {

// hits (7, n) [point3, normal3, active]; lists (n / 1024, list_stride);
// counts (n / 1024,); item_start (n / 1024 + 1,) with n_items =
// item_start[n / 1024]; photons (16, np_pad) and sbox (6, np_pad / 32),
// both 16-byte aligned; partial (n_items, 3, 1024); out (3, n); all device
// pointers, n a multiple of 1024. Returns the cudaError_t of the launches.
int pt_gather_chunks(const float* hits, const int* lists, const int* counts,
                     const int* item_start, int list_stride,
                     const float* photons, int np_pad, const float* sbox,
                     float r, float r_pad, int seg, int n_items,
                     float* partial, float* out, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_items > 0) {
    gather_chunks_items_kernel<<<n_items * QUARTERS, CTA, 0, s>>>(
        hits, lists, counts, item_start, n / BLOCK, list_stride, photons,
        np_pad, sbox, r, r_pad, seg, partial, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  gather_chunks_combine_kernel<<<(n + CTA - 1) / CTA, CTA, 0, s>>>(
      hits, item_start, partial, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
