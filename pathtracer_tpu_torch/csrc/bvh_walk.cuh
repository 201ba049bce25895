// What the two re-entry walks share: bvh8_walk.cu and bvh4_walk.cu. Their
// tables hold triangle-pair rows of one format (ops/bvh.py): the Moller-
// Trumbore test is one definition here, with the NaN-propagating min and
// max of the slab tests; bvh8_walk.cu combines a pair row's two tests
// (tri_pair), bvh4_walk.cu two pair rows' four (tri_quad).
//
// The triangle pair. The sequential walk tests the first triangle against
// the best t0, then the second against the result. Let ok_j be test j
// accepting against t0 (the t <= best rule). If ok1, the best is tt1 <=
// t0, and the second then accepts iff its other conditions hold and tt2 <=
// tt1, which implies tt2 <= t0: iff ok2 && tt2 <= tt1. If !ok1 the best is
// still t0, and the second accepts iff ok2. So the second wins iff ok2 &&
// (!ok1 || tt2 <= tt1), a tie tt2 == tt1 included; else the first wins
// iff ok1. An accepted tt is >= 0, never NaN.
//
// Four triangles (bvh4_walk.cu's leaf step: two pair rows). The walk tests
// triangles 1..m in order, each against the best so far. Let ok_j be test
// j accepting against the best t0 before the step, and best_j the best
// after j. Claim: best_{j-1} = min(t0, {tt_i : i < j, ok_i}). For j = 1
// it is t0. If test j accepts in the walk, its other conditions hold and
// tt_j <= best_{j-1} <= t0, so ok_j, and best_j = tt_j = min(best_{j-1},
// tt_j). If it does not, either !ok_j (the set gains nothing) or ok_j and
// tt_j > best_{j-1} (the minimum keeps its value): best_j = best_{j-1}
// either way, the claim for j + 1. So test j accepts in the walk iff ok_j
// and tt_j <= min(t0, {tt_i : i < j, ok_i}). Let A = {j : ok_j} be non-
// empty and M = min over A of tt_j. The walk's final best is its last
// accepted test's tt, and equals min(t0, M) = M (M <= t0): the winner w
// has tt_w = M. Every j in A with tt_j = M accepts (M is at most every
// earlier accepted tt, and at most t0), and no test after w accepts, so w
// is the last j in A with tt_j = M: the latest accepted triangle of least
// t, ties included. With A empty nothing changes. For m = 2 this is the
// pair's rule above. A triangle that the walk would not reach (the second
// row's, after a leaf's last row) is left out of A.
//
// Numerics, kept equal to the plain versions (and to the JAX walks):
// - min and max propagate NaN (jnp.minimum / maximum, torch.minimum /
//   maximum): 1/d of an axis-aligned ray is +-inf and a slab distance can
//   be 0 * inf = NaN, which must make the child miss, as must a NaN pad
//   box. fminf / fmaxf would drop the NaN, so the kernels use nan_min /
//   nan_max;
// - the triangle test accepts t <= best (the tile kernel's is strict),
//   with |det| >= 1e-6 and an IEEE division.

#pragma once

#include <stdint.h>

namespace pt_walk {

constexpr float BIG = 0x1.c363ccp+127f;  // np.float32(3.0e38)
constexpr float EPS = 0x1.0c6f7ap-20f;   // np.float32(1e-6)

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// One Moller-Trumbore test against the triangle at row columns
// [c, c + 9) against the best tb: whether it accepts, and its t, u, v.
__device__ __forceinline__ bool mt_test(const float* r, int c,
                                        const float o[3], const float d[3],
                                        float tb, float& tt, float& uu,
                                        float& vv) {
  const float ax = r[c], ay = r[c + 1], az = r[c + 2];
  const float e1x = r[c + 3], e1y = r[c + 4], e1z = r[c + 5];
  const float e2x = r[c + 6], e2y = r[c + 7], e2z = r[c + 8];
  const float pvx = d[1] * e2z - d[2] * e2y;  // pvec = d x e2
  const float pvy = d[2] * e2x - d[0] * e2z;
  const float pvz = d[0] * e2y - d[1] * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float det_inv = 1.0f / det;
  const float tvx = o[0] - ax, tvy = o[1] - ay, tvz = o[2] - az;
  uu = det_inv * (tvx * pvx + tvy * pvy + tvz * pvz);
  const float qvx = tvy * e1z - tvz * e1y;  // qvec = tvec x e1
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  vv = det_inv * (d[0] * qvx + d[1] * qvy + d[2] * qvz);
  tt = det_inv * (e2x * qvx + e2y * qvy + e2z * qvz);
  return (fabsf(det) >= EPS) && (uu >= 0.0f) && (uu <= 1.0f) &&
         (vv >= 0.0f) && (uu + vv <= 1.0f) && (tt >= 0.0f) && (tt <= tb);
}

// The triangle-pair row r (ri: its int view, staged in shared memory) for
// a group of lanes of one ray: g is the lane's place in the group, whose
// lanes are gmask, from lane `shift` of the warp. Lane 0 of the group
// tests the first triangle and lane 1 the second, both against the old
// best; every lane takes both results and combines them as above, so the
// group's best (tb, ub, vb, ib) stays the same in all its lanes.
__device__ __forceinline__ void tri_pair(const float* r, const int* ri,
                                         int g, unsigned gmask, int shift,
                                         const float o[3], const float d[3],
                                         float& tb, float& ub, float& vb,
                                         int& ib) {
  float tt = 0.0f, uu = 0.0f, vv = 0.0f;
  bool ok = false;
  if (g < 2) ok = mt_test(r, 12 * g, o, d, tb, tt, uu, vv);
  const int c1 = shift, c2 = shift + 1;
  const bool ok1 = __shfl_sync(gmask, (int)ok, c1) != 0;
  const bool ok2 = __shfl_sync(gmask, (int)ok, c2) != 0;
  const float tt1 = __shfl_sync(gmask, tt, c1);
  const float tt2 = __shfl_sync(gmask, tt, c2);
  const float uu1 = __shfl_sync(gmask, uu, c1);
  const float uu2 = __shfl_sync(gmask, uu, c2);
  const float vv1 = __shfl_sync(gmask, vv, c1);
  const float vv2 = __shfl_sync(gmask, vv, c2);
  if (ok2 && (!ok1 || tt2 <= tt1)) {
    tb = tt2;
    ub = uu2;
    vb = vv2;
    ib = ri[21];
  } else if (ok1) {
    tb = tt1;
    ub = uu1;
    vb = vv1;
    ib = ri[9];
  }
}

// The leaf step's combine for a group of 4 lanes of one ray: lane g
// holds triangle g's test against the best before the step (ok, its tt,
// uu, vv and index id), the group's lanes are gmask from lane `shift`.
// Two xor-shuffle rounds leave in every lane the least (key, -g), key =
// tt where ok, else +inf: the latest accepted triangle of least t (the
// proof above; an accepted tt is finite, <= tb <= BIG). Where it is
// accepted, the group's best (tb, ub, vb, ib) becomes it, in all lanes.
__device__ __forceinline__ void tri_quad(bool ok, float tt, float uu,
                                         float vv, int id, int g,
                                         unsigned gmask, int shift,
                                         float& tb, float& ub, float& vb,
                                         int& ib) {
  const float inf = __int_as_float(0x7f800000);
  float key = ok ? tt : inf;
  int w = g;
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    const float k2 = __shfl_xor_sync(gmask, key, m);
    const int w2 = __shfl_xor_sync(gmask, w, m);
    if (k2 < key || (k2 == key && w2 > w)) {
      key = k2;
      w = w2;
    }
  }
  const float uw = __shfl_sync(gmask, uu, shift + w);
  const float vw = __shfl_sync(gmask, vv, shift + w);
  const int iw = __shfl_sync(gmask, id, shift + w);
  if (key < inf) {
    tb = key;
    ub = uw;
    vb = vw;
    ib = iw;
  }
}

}  // namespace pt_walk
