// Shading from a given intersection, for Hopper (sm_90a): the second half
// of the two-kernel bounce.
//
// Replaces: pathtracer_tpu/ops/pallas/shade_kernel.py:shade_pallas (_kernel,
// which runs shade_body). The plain PyTorch version is
// ops/cuda/shade_kernel.py:shade_state_plain, and the output equals it
// exactly.
//
// Design: one thread per ray over the (10, n) state, the (n,) winner index
// and a*t key of csrc/intersect_state.cu, the (n,) offsets and the (3, n)
// radiance. A lane is hit when it is alive and at < BIG. A dead lane passes
// its state and radiance through; a live lane runs `shade_store` of
// csrc/pt_bounce.cuh, the same code as the fused bounce after its sphere
// loop: a miss adds the background and kills the lane, a hit is shaded
// (the packed material table is read through the read-only cache, the
// winner's 10 words only). New state and radiance tensors are written; the
// JAX kernel updates them in place, which is a TPU memory detail.
//
// Bound on this card: the bytes of the state (10 planes in, 10 out), the
// radiance (3 in, 3 out), the key, index and offset: 108 bytes a lane, and
// ~200 float32 operations a shaded lane. Left for later PRs: in-place
// update of the state, and regrouping lanes by material.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pt_bounce.cuh"

namespace {

constexpr int THREADS = 256;

struct Params {
  ShadeArgs sh;  // packed material table, offsets, limbs, background
  const float* st_in;  // (10, n)
  float* st_out;
  const int* idx;  // (n,)
  const float* at;  // (n,)
  const float* rad_in;  // (3, n)
  float* rad_out;
  int n;
};

template <int BG_MODE>
__global__ void __launch_bounds__(THREADS) shade_kernel(Params p) {
  const int n = p.n;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float st[10];
#pragma unroll
  for (int c = 0; c < 10; ++c) st[c] = p.st_in[c * n + i];
  float r_in[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) r_in[c] = p.rad_in[c * n + i];
  if (!(st[9] > 0.0f)) {
    pass_through(i, n, st, r_in, p.st_out, p.rad_out);
    return;
  }
  shade_store<BG_MODE>(p.sh, i, n, p.at[i] < BIG, p.idx[i], st, r_in,
                       p.st_out, p.rad_out);
}

}  // namespace

extern "C" {

// state_in/out (10, n), idx (n,), off (n,), at (n,), rad_in/out (3, n), all
// device pointers. Returns the cudaError_t.
int pt_shade_state(const float* pack, int pack_stride, const float* st_in,
                   float* st_out, const int* idx, const uint32_t* off,
                   const float* at, const float* rad_in, float* rad_out,
                   uint32_t u_hi, uint32_t u_lo, uint32_t v_hi, uint32_t v_lo,
                   float bg00, float bg01, float bg02, float bg10, float bg11,
                   float bg12, int n, int bg_mode, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  Params p{{pack, pack_stride, off, u_hi, u_lo, v_hi, v_lo,
            {bg00, bg01, bg02, bg10, bg11, bg12}},
           st_in,
           st_out,
           idx,
           at,
           rad_in,
           rad_out,
           n};
  const int grid = (n + THREADS - 1) / THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  if (bg_mode == 1) {
    shade_kernel<1><<<grid, THREADS, 0, s>>>(p);
  } else {
    shade_kernel<0><<<grid, THREADS, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
