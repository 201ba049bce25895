// PPM cone-filter photon gather over per-block chunk lists, for Hopper
// (sm_90a).
//
// Replaces: pathtracer_tpu/ops/pallas/gather_kernel.py:gather_flux_chunks_pallas
// (_kernel_chunks). The plain PyTorch version is
// ops/cuda/gather_kernel.py:gather_flux_chunks_plain, and the output equals
// it exactly.
//
// Design: one CTA of 1024 threads per 1024-hit block (hits Morton-sorted,
// so a block is spatially compact), one thread per hit. The block's list
// row (from block_chunk_lists, torch glue) stays in global memory and is
// read as a uniform word per step. Each listed 128-photon chunk (9 planes:
// pos, normal, flux; 4.6 KB) is staged through shared memory by the whole
// CTA, then every thread walks the chunk's 32-photon sub-chunks whose bit
// is set in the word's mask (an unsigned `word >> 24`), photon by photon.
// The TPU kernel double-buffered its DMAs and broadcast photons from SMEM
// scalars to 1024 lanes; here the broadcast is a shared-memory read that
// all threads of a warp share, and the CTA's two barriers per chunk stand
// in for the DMA waits.
//
// Each thread adds in the order of the JAX kernel (list position, then
// sub-chunk, then photon): w = 1 - sqrtf(d2) * (1/r) where d2 < r^2 and
// n . n_p > 1e-3, else 0, times the photon's flux. Built with -fmad=false
// and IEEE sqrt/division, so every lane rounds as the plain version does.
// Inactive lanes, and blocks whose list is empty, write 0.
//
// Bound on this card: FP32 issue and shared-memory reads, ~25 operations
// a hit-photon pair; every CTA stalls at the two barriers of each chunk.
// Left for later PRs: double-buffering the chunk copies (cp.async or TMA),
// culling sub-chunks per warp instead of per block, and a finer hit sort.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 1024;  // hits per CTA
constexpr int CHB = 128;  // photons per chunk
constexpr int SUB = 32;  // photons per sub-chunk
constexpr int N_SUBS = CHB / SUB;
constexpr int MASK_SHIFT = 24;
constexpr uint32_t CHUNK_MASK = (1u << MASK_SHIFT) - 1u;
constexpr float NDOT_MIN = 0x1.0624dep-10f;  // np.float32(1e-3)

__global__ void __launch_bounds__(BLOCK)
    gather_chunks_kernel(const float* __restrict__ hits,
                         const int* __restrict__ lists,
                         const int* __restrict__ counts, int list_stride,
                         const float* __restrict__ photons, int np_pad,
                         float r, float* __restrict__ out, int n) {
  __shared__ float ph[9][CHB];
  const size_t i = (size_t)blockIdx.x * BLOCK + threadIdx.x;
  const float x = hits[i], y = hits[n + i], z = hits[2 * (size_t)n + i];
  const float nx = hits[3 * (size_t)n + i], ny = hits[4 * (size_t)n + i],
              nz = hits[5 * (size_t)n + i];
  const bool act = hits[6 * (size_t)n + i] > 0.0f;
  const int cnt = counts[blockIdx.x];
  const int* list = lists + (size_t)blockIdx.x * list_stride;
  const float inv_r = 1.0f / r;
  const float r2 = r * r;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int k = 0; k < cnt; ++k) {
    const uint32_t word = (uint32_t)list[k];
    const size_t base = (size_t)(word & CHUNK_MASK) * CHB;
    const uint32_t mask = word >> MASK_SHIFT;
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < 9 * CHB; e += BLOCK)
      ph[e / CHB][e % CHB] = photons[(size_t)(e / CHB) * np_pad + base +
                                     e % CHB];
    __syncthreads();
    for (int t = 0; t < N_SUBS; ++t) {
      if (!((mask >> t) & 1u)) continue;
      for (int j = t * SUB; j < (t + 1) * SUB; ++j) {
        const float dx = ph[0][j] - x;
        const float dy = ph[1][j] - y;
        const float dz = ph[2][j] - z;
        const float d2 = dx * dx + dy * dy + dz * dz;
        const float ndot = ph[3][j] * nx + ph[4][j] * ny + ph[5][j] * nz;
        const bool ok = (d2 < r2) && (ndot > NDOT_MIN);
        const float wf = ok ? 1.0f - sqrtf(d2) * inv_r : 0.0f;
        a0 = a0 + wf * ph[6][j];
        a1 = a1 + wf * ph[7][j];
        a2 = a2 + wf * ph[8][j];
      }
    }
  }
  out[i] = act ? a0 : 0.0f;
  out[n + i] = act ? a1 : 0.0f;
  out[2 * (size_t)n + i] = act ? a2 : 0.0f;
}

}  // namespace

extern "C" {

// hits (7, n) [point3, normal3, active]; lists (n / 1024, list_stride);
// counts (n / 1024,); photons (16, np_pad); out (3, n); all device pointers,
// n a multiple of 1024. Returns the cudaError_t.
int pt_gather_chunks(const float* hits, const int* lists, const int* counts,
                     int list_stride, const float* photons, int np_pad,
                     float r, float* out, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  gather_chunks_kernel<<<n / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      hits, lists, counts, list_stride, photons, np_pad, r, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
