// Nearest hit of origin-zero primary rays against per-tile frustum-culled
// triangle lists, for Hopper (sm_90a): the eye pass of a mesh scene whose
// eye paths end at their first hit (ganesha).
//
// Replaces: pathtracer_tpu/ops/pallas/tile_tri_kernel.py:
// intersect_tile_tris_pallas (_kernel). The plain PyTorch version is
// ops/cuda/tile_tri_kernel.py:intersect_tile_tris_plain, and the output
// equals it exactly.
//
// Design: each 256-triangle chunk of the CSR map (tile_chunk_start /
// tile_chunk_src) is one work item, so a tile's list is walked by as many
// CTAs as it has chunks. The lists' lengths vary 20-fold (ganesha: mean
// 434, longest 9,271 triangles), so one CTA per tile left the card waiting
// on the longest tile. The grid is four CTAs per chunk, sized from the
// shapes alone with no read of the map on the host; chunk c belongs to the
// last tile t with start(t) <= c.
//
// Pass 1 (intersect_tile_tris_items_kernel): four CTAs of 256 threads per
// chunk, each 8 rows of the 32x32 tile, one thread per pixel. The chunk
// (table rows 0-9: a, e1, e2, index; 10 KB) is staged in shared memory
// with cp.async, and every thread tests its ray against the chunk's
// columns in ascending order with its running best (t, u, v, index) in
// registers, starting from (BIG, 0, 0, 0), with the strict `t < best`
// update. The chunk's best goes to partial[c][4][1024].
// Pass 2 (intersect_tile_tris_combine_kernel): one thread per pixel scans
// its tile's chunks in order and keeps a chunk's best only where its t is
// strictly smaller than the best so far: the first minimum over the whole
// list, which is what the sequential strict-< walk gives. Directions are read,
// and results written, in raster lane order (lane = y * width + x); pixels
// past the image width own no lane.
//
// Numerics, kept equal to the plain version: origin-zero Moller-Trumbore
// in the JAX kernel's order (pvec = d x e2, det, inv = 1/det,
// u = -inv * (a . pvec), qvec = a x e1 with the sign of tvec = -a folded
// in, v, t), the acceptance tests (|det| >= 1e-6, 0 <= u <= 1, v >= 0,
// u + v <= 1, t >= 0) and the strict `t < best` update, so ties go to the
// lowest index; the index is row 9 read as f32 and truncated to int. A
// pair that fails |det| >= 1e-6 (the zero padding columns among them) is
// never accepted, so its division and the rest are skipped. Built with
// -fmad=false and IEEE division.
//
// Bound on this card: FP32 issue, ~45 flops and one division per
// ray-triangle pair over the tile's list. Left for later PRs: the division
// per pair (removing it changes the bits), and a table without the padding
// to whole chunks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int TILE = 32;
constexpr int RAYS = TILE * TILE;
constexpr int CTA = 256;  // threads per CTA: 8 rows of a tile
constexpr int QUARTERS = RAYS / CTA;
constexpr int CHUNK = 256;
constexpr int ROWS = 10;  // a, e1, e2, index
constexpr int STAGE_VECS = ROWS * CHUNK / 4;  // 16-byte pieces of a chunk
constexpr float BIG = 0x1.c363ccp+127f;  // np.float32(3.0e38)
constexpr float EPS = 0x1.0c6f7ap-20f;  // np.float32(1e-6)

// The tile of chunk c: the last tile t with chunk_start[t] <= c.
__device__ __forceinline__ int chunk_tile(const int* __restrict__ chunk_start,
                                          int n_tiles, int c) {
  int lo = 0, hi = n_tiles;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (chunk_start[mid] <= c) lo = mid; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void stage_chunk(float (*tri)[CHUNK],
                                            const float* __restrict__ table,
                                            int n_cols, size_t col0) {
  for (int e = threadIdx.x; e < STAGE_VECS; e += CTA) {
    const int r = e / (CHUNK / 4), j = 4 * (e % (CHUNK / 4));
    pt_async::copy16(&tri[r][j], table + (size_t)r * n_cols + col0 + j);
  }
  pt_async::commit();
}

__global__ void __launch_bounds__(CTA)
    intersect_tile_tris_items_kernel(const float* __restrict__ table,
                                     int n_cols,
                                     const int* __restrict__ chunk_start,
                                     const int* __restrict__ chunk_src,
                                     int n_tiles, int tx_n,
                                     const float* __restrict__ dir, int width,
                                     float* __restrict__ partial) {
  __shared__ __align__(16) float tri[ROWS][CHUNK];
  const int c = blockIdx.x / QUARTERS;
  const int tile = chunk_tile(chunk_start, n_tiles, c);
  const int ray = (blockIdx.x % QUARTERS) * CTA + threadIdx.x;
  const int x = (tile % tx_n) * TILE + ray % TILE;
  const int y = (tile / tx_n) * TILE + ray / TILE;
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
  stage_chunk(tri, table, n_cols, (size_t)chunk_src[c] * CHUNK);
  pt_async::wait<0>();
  __syncthreads();  // the chunk has landed for every thread
  if (mine) {
    for (int j = 0; j < CHUNK; ++j) {
      const float e2x = tri[6][j], e2y = tri[7][j], e2z = tri[8][j];
      const float e1x = tri[3][j], e1y = tri[4][j], e1z = tri[5][j];
      const float pvx = d1 * e2z - d2 * e2y;
      const float pvy = d2 * e2x - d0 * e2z;
      const float pvz = d0 * e2y - d1 * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      if (!(fabsf(det) >= EPS)) continue;  // never accepted
      const float ax = tri[0][j], ay = tri[1][j], az = tri[2][j];
      const float inv = 1.0f / det;
      const float uu = -inv * (ax * pvx + ay * pvy + az * pvz);
      const float qvx = az * e1y - ay * e1z;
      const float qvy = ax * e1z - az * e1x;
      const float qvz = ay * e1x - ax * e1y;
      const float vv = inv * (d0 * qvx + d1 * qvy + d2 * qvz);
      const float tt = inv * (e2x * qvx + e2y * qvy + e2z * qvz);
      if ((uu >= 0.0f) && (uu <= 1.0f) && (vv >= 0.0f) &&
          (uu + vv <= 1.0f) && (tt >= 0.0f) && (tt < bt)) {
        bt = tt;
        bu = uu;
        bv = vv;
        bi = (int)tri[9][j];
      }
    }
  }
  float* p = partial + (size_t)c * 4 * RAYS + ray;
  p[0] = bt;
  p[RAYS] = bu;
  p[2 * RAYS] = bv;
  p[3 * RAYS] = __int_as_float(bi);
}

__global__ void __launch_bounds__(CTA)
    intersect_tile_tris_combine_kernel(const int* __restrict__ chunk_start,
                                       int n_tiles, int tx_n, int n_chunks,
                                       const float* __restrict__ partial,
                                       int width, int n_lanes,
                                       float* __restrict__ t_out,
                                       float* __restrict__ u_out,
                                       float* __restrict__ v_out,
                                       int* __restrict__ idx_out) {
  const int lane = blockIdx.x * CTA + threadIdx.x;
  if (lane >= n_lanes) return;
  const int x = lane % width, y = lane / width;
  const int tile = (y / TILE) * tx_n + x / TILE;
  const int ray = (y % TILE) * TILE + x % TILE;
  float bt = BIG, bu = 0.0f, bv = 0.0f;
  int bi = 0;
  if (tile < n_tiles) {
    const int end = min(chunk_start[tile + 1], n_chunks);
    for (int k = chunk_start[tile]; k < end; ++k) {
      const float* p = partial + (size_t)k * 4 * RAYS + ray;
      if (p[0] < bt) {
        bt = p[0];
        bu = p[RAYS];
        bv = p[2 * RAYS];
        bi = __float_as_int(p[3 * RAYS]);
      }
    }
  }
  t_out[lane] = bt;
  u_out[lane] = bu;
  v_out[lane] = bv;
  idx_out[lane] = bi;
}

}  // namespace

extern "C" {

// table (16, n_cols) f32, 16-byte aligned; chunk_start (n_tiles+1,),
// chunk_src (n_chunks,) int32 with chunk_start[n_tiles] = n_chunks; dir
// (rows*width, 3) f32 raster order with rows = (n_tiles/tx_n)*32; partial
// (n_chunks, 4, 1024) f32; t, u, v (rows*width,) f32, idx int32. All
// device pointers. Returns the cudaError_t of the launches.
int pt_intersect_tile_tris(const float* table, int n_cols,
                           const int* chunk_start, const int* chunk_src,
                           int n_tiles, int tx_n, int n_chunks,
                           const float* dir, int width, float* partial,
                           float* t, float* u, float* v, int* idx,
                           void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_chunks > 0) {
    intersect_tile_tris_items_kernel<<<n_chunks * QUARTERS, CTA, 0, s>>>(
        table, n_cols, chunk_start, chunk_src, n_tiles, tx_n, dir, width,
        partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int n_lanes = (n_tiles / tx_n) * TILE * width;
  const int grid = (n_lanes + CTA - 1) / CTA;
  intersect_tile_tris_combine_kernel<<<grid, CTA, 0, s>>>(
      chunk_start, n_tiles, tx_n, n_chunks, partial, width, n_lanes, t, u, v,
      idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
