// Nearest ray/triangle hit (Moller-Trumbore) for Hopper (sm_90a): the
// triangle pool of mixed scenes (cornell-box's walls and light box, the
// ganesha floor).
//
// Replaces: pathtracer_tpu/ops/pallas/tri_kernel.py:intersect_tris_pallas
// (_kernel). The plain PyTorch version is
// ops/cuda/tri_kernel.py:intersect_tris_plain, and the output equals it
// exactly.
//
// Bound on this card: the larger of the rays' 33 bytes (origin, direction,
// alive byte, t and index) and the FP32 operations of the pairs of the real
// triangles (18 on cornell, 2 on ganesha; the table holds T = 128 columns,
// the rest padding), each pair counted where it leaves: 14 at the |det|
// test (pvec, det), 23 at the u tests (tvec, U, |det| M1), 44 at the v, t
// and u + v tests (qvec, V, Tn, the sum, |det| M2), 46 for the full test
// (tri_kernel.tri_pair_stages says where each pair leaves).
//
// Design: one CTA of 256 threads per 256 rays, one thread per ray, so that a
// launch is 4x as many CTAs as 1024-ray blocks and the card's last wave is
// short. Each CTA any-reduces the alive bytes of its enclosing 1024-ray
// block (4 a thread) and, if none is alive, writes (BIG, 0) and exits: the
// block early exit of the JAX kernel. It then stages the real columns of
// the (9, T) table into shared memory, in column order, as three float4s a
// triangle [a, column], [e1, -], [e2, -] (a ballot and a prefix count over
// the warps), and every thread walks only those. Each pair first runs a
// division-free pre-reject; a pair that passes it runs the unchanged
// arithmetic: the operations of the JAX kernel in its order (pvec = d x e2,
// det, det_inv = 1/det, u, qvec = tvec x e1, v, t), the six acceptance
// tests (|det| >= 1e-6, 0 <= u <= 1, v >= 0, u + v <= 1, t >= 0) and the
// strict `cand < best` update, so ties go to the lowest column. Built with
// -fmad=false and IEEE division.
//
// Why a skipped pair changes no bit. A pair the full test does not accept
// has cand = BIG, and `BIG < best_t` never holds (best_t starts at BIG and
// only decreases), so leaving the pair out leaves (best_t, best_idx) as
// they were; the walk keeps the column order, so ties still go to the
// lowest column, and a ray that accepts nothing keeps (BIG, 0). It remains
// to show that the full test rejects every skipped pair.
//
// (1) Pad columns: all six edge components are +-0 (a column with any
// other value, NaN included, is staged). Then each component of
// pvec = d x e2 is a difference of products with an e2 factor +-0: +-0
// when d is finite, NaN when d holds an inf or a NaN. det = e1 . pvec is a
// sum of products with an e1 factor +-0: +-0 or NaN. |det| >= 1e-6 fails
// for both, so the pair is rejected whatever the origin.
//
// (2) The pre-reject, with ad = |det|, su = U, sv = V, st = Tn, each with
// its sign flipped (exactly) when det < 0, where U = tvec . pvec,
// V = d . qvec and Tn = e2 . qvec are the dot products that uu, vv and tt
// scale by det_inv; TINY = 2^-64, M1 = 1 + 2^-20, M2 = 1 + 2^-18:
//   a. !(ad >= 1e-6): the full test's own first condition, the same float
//      comparison (NaN and |det| below or at 1e-6 as there: exactly 1e-6
//      passes both);
//   b. only where ad <= 2^64 ("regular"; a larger or inf det skips b):
//      su < -TINY (u < 0), su > fl(ad * M1) (u > 1), sv < -TINY (v < 0),
//      st < -TINY (t < 0), fl(su + sv) > fl(ad * M2) (u + v > 1).
// In the regular range 1/det is normal (2^-64 <= |1/det| <= 1e6), so
// det_inv = (1/det)(1 + e), |e| <= 2^-24, and it has det's sign; rounding
// is monotone; fl(x) lies within 2^-24 |x| + 2^-150 of x (2^-150 for a
// subnormal result). Let a = su / ad = U / det (exact), likewise b for V.
//   u < 0: |a| >= 2^-64 / 2^64 = 2^-128, so |det_inv * U| > 2^-149 and
//      uu = fl(det_inv * U) is a nonzero negative number (or -inf for
//      su = -inf): `uu >= 0` fails. A product that underflows to -0.0
//      would pass `uu >= 0`; it needs |a| < 2^-149, hence |su| < TINY,
//      which b never rejects. u exactly 0 (su = +-0) is not rejected.
//   v < 0 and t < 0: the same argument for vv and tt (t = -0.0 has
//      st = +-0, not rejected).
//   u > 1: fl(ad * M1) >= ad * M1 (1 - 2^-24), so a > (1 + 2^-20)(1 - 2^-24)
//      > 1 + 2^-21; det_inv * U = (1 + e) a > 1 + 2^-22, so uu >= 1 + 2^-22
//      (a float) and `uu <= 1` fails; su = +inf gives uu = +inf. u exactly
//      1 (su = ad) is not rejected, since fl(ad * M1) >= ad.
//   u + v > 1: the sum's result is positive, so (su + sv)(1 + 2^-24) >=
//      fl(su + sv) > fl(ad * M2) >= ad M2 (1 - 2^-24), hence a + b >
//      M2 (1 - 2^-23) > 1 + 2^-19. su and sv passed the earlier tests, so
//      a, b >= -TINY / 1e-6 > -2^-44 and |a| + |b| <= a + b + 2^-42. With
//      the bound on fl, uu + vv >= (1 + e)(a + b) - 2^-24 (1 + 2^-24)
//      (|a| + |b|) - 2^-149 > (a + b)(1 - 2^-22) - 2^-64 > 1 + 2^-20, so
//      fl(uu + vv) > 1 and `uu + vv <= 1` fails; sv = +inf makes vv and
//      the sum +inf.
//   NaN: every comparison with a NaN is false, so a NaN su, sv or st (or
//      su + sv) rejects nothing in b; only a's own comparison rejects it,
//      as the full test does.
// tests/test_torch_tri_pads.py checks each case above on the CPU with the
// plain emulation ops/cuda/tri_kernel.py:tri_pair_tests, which repeats
// these float operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RAY_BLOCK = 1024;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float BIG = 0x1.c363ccp+127f;  // np.float32(3.0e38)
constexpr float EPS = 0x1.0c6f7ap-20f;  // np.float32(1e-6)
constexpr float REGULAR = 0x1p64f;  // the pre-reject's largest |det|
constexpr float TINY = 0x1p-64f;
constexpr float M1 = 0x1.00001p0f;  // 1 + 2^-20
constexpr float M2 = 0x1.00004p0f;  // 1 + 2^-18

__global__ void __launch_bounds__(THREADS)
    intersect_tris_kernel(const float* __restrict__ tab, int n_tris,
                          const float* __restrict__ org,
                          const float* __restrict__ dir,
                          const uint8_t* __restrict__ alive,
                          float* __restrict__ t_out,
                          int* __restrict__ idx_out) {
  extern __shared__ float4 tri[];  // (real columns, 3) [a, col] [e1] [e2]
  __shared__ int warp_real[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t i = (size_t)blockIdx.x * THREADS + tid;
  const uint8_t* blk = alive + (i / RAY_BLOCK) * RAY_BLOCK + 4 * tid;
  if (!__syncthreads_or(blk[0] | blk[1] | blk[2] | blk[3])) {
    t_out[i] = BIG;
    idx_out[i] = 0;
    return;
  }
  // stage the real columns, in column order
  int n_real = 0;
  for (int c0 = 0; c0 < n_tris; c0 += THREADS) {
    const int c = c0 + tid;
    float v[9];
    bool real = false;
    if (c < n_tris) {
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = tab[k * n_tris + c];
      real = v[3] != 0.0f || v[4] != 0.0f || v[5] != 0.0f || v[6] != 0.0f ||
             v[7] != 0.0f || v[8] != 0.0f;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, real);
    if (lane == 0) warp_real[warp] = __popc(mask);
    __syncthreads();
    int base = n_real, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int cnt = warp_real[w];
      base += w < warp ? cnt : 0;
      total += cnt;
    }
    if (real) {
      const int k = base + __popc(mask & ((1u << lane) - 1u));
      tri[3 * k] = make_float4(v[0], v[1], v[2], __int_as_float(c));
      tri[3 * k + 1] = make_float4(v[3], v[4], v[5], 0.0f);
      tri[3 * k + 2] = make_float4(v[6], v[7], v[8], 0.0f);
    }
    n_real += total;
    __syncthreads();  // publishes tri; warp_real is read before reuse
  }
  const float d0 = dir[3 * i], d1 = dir[3 * i + 1], d2 = dir[3 * i + 2];
  const float o0 = org[3 * i], o1 = org[3 * i + 1], o2 = org[3 * i + 2];
  float best_t = BIG;
  int best_idx = 0;
  for (int k = 0; k < n_real; ++k) {
    const float4 ta = tri[3 * k], t1 = tri[3 * k + 1], t2 = tri[3 * k + 2];
    const float pvx = d1 * t2.z - d2 * t2.y;  // pvec = d x e2
    const float pvy = d2 * t2.x - d0 * t2.z;
    const float pvz = d0 * t2.y - d1 * t2.x;
    const float det = t1.x * pvx + t1.y * pvy + t1.z * pvz;
    const float ad = fabsf(det);
    if (!(ad >= EPS)) continue;  // (2a)
    const bool regular = ad <= REGULAR;
    const float tvx = o0 - ta.x, tvy = o1 - ta.y, tvz = o2 - ta.z;
    const float uu_n = tvx * pvx + tvy * pvy + tvz * pvz;
    const float su = det < 0.0f ? -uu_n : uu_n;
    if (regular && (su < -TINY || su > ad * M1)) continue;  // (2b) u
    const float qvx = tvy * t1.z - tvz * t1.y;  // qvec = tvec x e1
    const float qvy = tvz * t1.x - tvx * t1.z;
    const float qvz = tvx * t1.y - tvy * t1.x;
    const float vv_n = d0 * qvx + d1 * qvy + d2 * qvz;
    const float tt_n = t2.x * qvx + t2.y * qvy + t2.z * qvz;
    const float sv = det < 0.0f ? -vv_n : vv_n;
    const float st = det < 0.0f ? -tt_n : tt_n;
    if (regular && (sv < -TINY || st < -TINY || su + sv > ad * M2))
      continue;  // (2b) v, t, u + v
    const float det_inv = 1.0f / det;
    const float uu = det_inv * uu_n;
    const float vv = det_inv * vv_n;
    const float tt = det_inv * tt_n;
    const bool ok = (uu >= 0.0f) && (uu <= 1.0f) && (vv >= 0.0f) &&
                    (uu + vv <= 1.0f) && (tt >= 0.0f);
    const float cand = ok ? tt : BIG;
    if (cand < best_t) {
      best_t = cand;
      best_idx = __float_as_int(ta.w);
    }
  }
  t_out[i] = best_t;
  idx_out[i] = best_idx;
}

}  // namespace

extern "C" {

// tab (9, T), 0 < T <= 1024; org, dir (n, 3); alive (n,) bool; t, idx (n,);
// all device pointers, n a multiple of 1024. Returns the cudaError_t.
int pt_intersect_tris(const float* tab, int n_tris, const float* org,
                      const float* dir, const uint8_t* alive, float* t,
                      int* idx, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = 3 * sizeof(float4) * (size_t)n_tris;
  if (smem > 40 * 1024) {  // past the default 48 KB with the static part
    const cudaError_t err = cudaFuncSetAttribute(
        intersect_tris_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  intersect_tris_kernel<<<n / THREADS, THREADS, smem, (cudaStream_t)stream>>>(
      tab, n_tris, org, dir, alive, t, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
