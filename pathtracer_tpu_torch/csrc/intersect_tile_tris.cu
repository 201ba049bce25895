// Nearest hit of origin-zero primary rays against per-tile frustum-culled
// triangle lists, for Hopper (sm_90a): the eye pass of a mesh scene whose
// eye paths end at their first hit (ganesha).
//
// Replaces: pathtracer_tpu/ops/pallas/tile_tri_kernel.py:
// intersect_tile_tris_pallas (_kernel). The plain PyTorch version is
// ops/cuda/tile_tri_kernel.py:intersect_tile_tris_plain, and the output
// equals it exactly.
//
// Design: one CTA of 1024 threads per 32x32 image tile, one thread per
// pixel. The TPU kernel's sequential grid over (tile, chunk) pairs with a
// carried running minimum becomes a loop inside the CTA over the tile's
// chunk range of the CSR map (tile_chunk_start / tile_chunk_src): no dummy
// chunks, no trailing dummy block, no first-chunk flags. Each 256-triangle
// chunk (table rows 0-9: a, e1, e2, index; 10 KB) is staged in shared
// memory, and every thread tests its ray against the chunk's columns in
// ascending order with the running best (t, u, v, index) in registers.
// Directions are read, and results written, in raster lane order
// (lane = y * width + x), so the eye pass needs no lane permutation around
// the kernel; threads past the image width load chunks but own no lane.
//
// Numerics, kept equal to the plain version: origin-zero Moller-Trumbore
// in the JAX kernel's order (pvec = d x e2, det, inv = 1/det,
// u = -inv * (a . pvec), qvec = a x e1 with the sign of tvec = -a folded
// in, v, t), the acceptance tests (|det| >= 1e-6, 0 <= u <= 1, v >= 0,
// u + v <= 1, t >= 0) and the strict `t < best` update, so ties go to the
// lowest index; the index is row 9 read as f32 and truncated to int.
// Built with -fmad=false and IEEE division.
//
// Bound on this card: FP32 issue, ~45 flops and one division per
// ray-triangle pair over the tile's list (padding columns to the next 256
// included). Left for later PRs: the division per pair, and splitting the
// longest lists over several CTAs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int RAYS = TILE * TILE;
constexpr int CHUNK = 256;
constexpr int ROWS = 10;  // a, e1, e2, index
constexpr float BIG = 0x1.c363ccp+127f;  // np.float32(3.0e38)
constexpr float EPS = 0x1.0c6f7ap-20f;  // np.float32(1e-6)

__global__ void __launch_bounds__(RAYS)
    intersect_tile_tris_kernel(const float* __restrict__ table, int n_cols,
                               const int* __restrict__ chunk_start,
                               const int* __restrict__ chunk_src, int tx_n,
                               const float* __restrict__ dir, int width,
                               float* __restrict__ t_out,
                               float* __restrict__ u_out,
                               float* __restrict__ v_out,
                               int* __restrict__ idx_out) {
  __shared__ float tri[ROWS][CHUNK];
  const int tile = blockIdx.x;
  const int x = (tile % tx_n) * TILE + threadIdx.x % TILE;
  const int y = (tile / tx_n) * TILE + threadIdx.x / TILE;
  const bool mine = x < width;
  const size_t lane = (size_t)y * width + x;
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  if (mine) {
    d0 = dir[3 * lane];
    d1 = dir[3 * lane + 1];
    d2 = dir[3 * lane + 2];
  }
  float bt = BIG, bu = 0.0f, bv = 0.0f;
  int bi = 0;
  const int c_end = chunk_start[tile + 1];
  for (int c = chunk_start[tile]; c < c_end; ++c) {
    const size_t col0 = (size_t)chunk_src[c] * CHUNK;
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < ROWS * CHUNK; e += RAYS) {
      const int r = e / CHUNK, j = e % CHUNK;
      tri[r][j] = table[(size_t)r * n_cols + col0 + j];
    }
    __syncthreads();
    if (!mine) continue;
    for (int j = 0; j < CHUNK; ++j) {
      const float ax = tri[0][j], ay = tri[1][j], az = tri[2][j];
      const float e1x = tri[3][j], e1y = tri[4][j], e1z = tri[5][j];
      const float e2x = tri[6][j], e2y = tri[7][j], e2z = tri[8][j];
      const float pvx = d1 * e2z - d2 * e2y;
      const float pvy = d2 * e2x - d0 * e2z;
      const float pvz = d0 * e2y - d1 * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const float inv = 1.0f / det;
      const float uu = -inv * (ax * pvx + ay * pvy + az * pvz);
      const float qvx = az * e1y - ay * e1z;
      const float qvy = ax * e1z - az * e1x;
      const float qvz = ay * e1x - ax * e1y;
      const float vv = inv * (d0 * qvx + d1 * qvy + d2 * qvz);
      const float tt = inv * (e2x * qvx + e2y * qvy + e2z * qvz);
      if ((fabsf(det) >= EPS) && (uu >= 0.0f) && (uu <= 1.0f) &&
          (vv >= 0.0f) && (uu + vv <= 1.0f) && (tt >= 0.0f) && (tt < bt)) {
        bt = tt;
        bu = uu;
        bv = vv;
        bi = (int)tri[9][j];
      }
    }
  }
  if (mine) {
    t_out[lane] = bt;
    u_out[lane] = bu;
    v_out[lane] = bv;
    idx_out[lane] = bi;
  }
}

}  // namespace

extern "C" {

// table (16, n_cols) f32; chunk_start (n_tiles+1,), chunk_src (C,) int32;
// dir (rows*width, 3) f32 raster order with rows = (n_tiles/tx_n)*32;
// t, u, v (rows*width,) f32, idx int32. All device pointers. Returns the
// cudaError_t of the launch.
int pt_intersect_tile_tris(const float* table, int n_cols,
                           const int* chunk_start, const int* chunk_src,
                           int n_tiles, int tx_n, const float* dir, int width,
                           float* t, float* u, float* v, int* idx,
                           void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  intersect_tile_tris_kernel<<<n_tiles, RAYS, 0, (cudaStream_t)stream>>>(
      table, n_cols, chunk_start, chunk_src, tx_n, dir, width, t, u, v, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
