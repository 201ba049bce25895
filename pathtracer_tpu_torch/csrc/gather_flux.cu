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
// Design: one thread per hit walks its own 9 ranges, offset 0..8 and then
// photon index ascending, and adds (1 - d/r) * flux where d^2 < r^2 and
// n . n_p > 1e-3. The TPU kernel streamed each 1024-hit block's union range
// through SMEM in double-buffered 128-photon DMAs and broadcast every
// photon to all lanes, testing `s <= idx < e` per lane: a photon outside a
// lane's range added an exact +0.0, so its per-lane sums are exactly these,
// in this order. Walking the lane's own ranges drops the union's dead
// photons (the JAX code measured ~89% of streamed chunks dead) and every
// barrier; a block-shared chunk stream through shared memory would bring
// back both. Hits come sorted by their cell's Morton key, so a warp's
// ranges overlap and its loads of one photon are served by the same L1
// line. Built with -fmad=false and IEEE sqrt/division, so every lane
// rounds as the plain version does.
//
// Bound on this card: FP32 throughput, 22 operations a hit-photon pair of
// its ranges (cell / r of 1 to 3 makes that 27 cells of photons for a
// sphere of radius r); the photons' 36 bytes are read from L1/L2 many times
// but from device memory about once. Left for later PRs: a warp-cooperative
// walk (one range streamed through shared memory per warp) and splitting
// long ranges.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int N_OFF = 9;  // (dy, dz) rows of the 3x3x3 neighbourhood
constexpr float NDOT_MIN = 0x1.0624dep-10f;  // np.float32(1e-3)

__global__ void __launch_bounds__(THREADS)
    gather_flux_kernel(const float* __restrict__ hits,
                       const int* __restrict__ s_tab,
                       const int* __restrict__ e_tab,
                       const float* __restrict__ photons, int np_pad, float r,
                       float* __restrict__ out, int n) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)n) return;
  const float x = hits[i], y = hits[n + i], z = hits[2 * (size_t)n + i];
  const float nx = hits[3 * (size_t)n + i], ny = hits[4 * (size_t)n + i],
              nz = hits[5 * (size_t)n + i];
  const float inv_r = 1.0f / r;
  const float r2 = r * r;
  const float* px = photons;
  const float* py = photons + np_pad;
  const float* pz = photons + 2 * (size_t)np_pad;
  const float* qx = photons + 3 * (size_t)np_pad;
  const float* qy = photons + 4 * (size_t)np_pad;
  const float* qz = photons + 5 * (size_t)np_pad;
  const float* f0 = photons + 6 * (size_t)np_pad;
  const float* f1 = photons + 7 * (size_t)np_pad;
  const float* f2 = photons + 8 * (size_t)np_pad;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int o = 0; o < N_OFF; ++o) {
    const int s = s_tab[o * (size_t)n + i];
    const int e = e_tab[o * (size_t)n + i];
    for (int j = s; j < e; ++j) {
      const float dx = __ldg(px + j) - x;
      const float dy = __ldg(py + j) - y;
      const float dz = __ldg(pz + j) - z;
      const float d2 = dx * dx + dy * dy + dz * dz;
      const float ndot = __ldg(qx + j) * nx + __ldg(qy + j) * ny +
                         __ldg(qz + j) * nz;
      if (d2 < r2 && ndot > NDOT_MIN) {
        const float w = 1.0f - sqrtf(d2) * inv_r;
        a0 = a0 + w * __ldg(f0 + j);
        a1 = a1 + w * __ldg(f1 + j);
        a2 = a2 + w * __ldg(f2 + j);
      }
    }
  }
  out[i] = a0;
  out[n + i] = a1;
  out[2 * (size_t)n + i] = a2;
}

}  // namespace

extern "C" {

// hits (6, n) [point3, normal3]; s_tab, e_tab (9, n) int32; photons
// (16, np_pad); out (3, n); all device pointers. Returns the cudaError_t.
int pt_gather_flux(const float* hits, const int* s_tab, const int* e_tab,
                   const float* photons, int np_pad, float r, float* out,
                   int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  gather_flux_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                       (cudaStream_t)stream>>>(hits, s_tab, e_tab, photons,
                                               np_pad, r, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
