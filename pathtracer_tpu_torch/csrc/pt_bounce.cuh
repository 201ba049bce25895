// The two halves of a path-tracer bounce, per lane: the nearest sphere and
// the shading. csrc/fused_bounce.cu runs both in one kernel; the two-kernel
// bounce runs the first in csrc/intersect_state.cu and the second in
// csrc/shade.cu. All three include this one copy of the arithmetic.
//
// Port of pathtracer_tpu/ops/pallas/sphere_kernel.py:intersect_regs and
// intersect_regs_listed (`stage_spheres`, `nearest_sphere`) and of
// shade_kernel.py:shade_body with its helpers _atan_poly, _atan2, _acos,
// _lds (`shade_lane`, `shade_store`). They mirror the plain versions line
// for line: ops/cuda/sphere_kernel.py:intersect_regs / intersect_regs_listed
// and ops/cuda/shade_kernel.py:shade.
//
// Numerics, kept equal to the plain version (the including files are built
// with -fmad=false and without fast math):
//  - a negative discriminant makes sqrtf NaN, which `at >= 0` rejects
//    (NaN-miss); the key is a*t with the /a dropped (directions are unit);
//    ties go to the lowest index (nearest_sphere below);
//  - 1.0f / sqrtf(x) where the JAX code has lax.rsqrt (rsqrtf is approximate);
//  - jnp.maximum / jnp.clip propagate NaN, hence jmax / jmin below;
//  - float constants are the float32 values of the JAX code, as hex literals.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RAY_BLOCK = 1024;  // rays per tile block (listed variants)
constexpr float BIG = 0x1.c363ccp+127f;  // np.float32(3.0e38)
constexpr float PI_F = 0x1.921fb6p+1f;
constexpr float HALF_PI_F = 0x1.921fb6p+0f;
constexpr float TWO_PI_F = 0x1.921fb6p+2f;
constexpr float TWO_PI_INV_F = 0x1.45f306p-3f;
constexpr float PI_INV_F = 0x1.45f306p-2f;
constexpr float C15 = 0x1.0002p-15f;  // 1 / 32767
constexpr float C16 = 0x1.0001p-16f;  // 1 / 65535
constexpr float TINY30 = 0x1.4484cp-100f;  // 1e-30
constexpr float TINY38 = 0x1.b38fb8p-127f;  // 1e-38
constexpr float POLE_TOP = 0x1.ffffdep-1f;  // 1 - 1e-6 in float32
constexpr float POLE_BOT = -0x1.ffffdep-1f;
constexpr float SHADOW = 0x1.0624dep-10f;  // 1e-3
constexpr float LDS_SCALE = 0x1p-31f;
constexpr float ONE_MINUS_EPS = 0x1.fffffep-1f;

// What the shading reads besides the lane's own state: the packed material
// table (10, pack_stride), the LDS offsets (n,), this bounce's two sampler
// limbs and the background rows [row 0 rgb, row 1 rgb].
struct ShadeArgs {
  const float* pack;
  int pack_stride;
  const uint32_t* off;
  uint32_t u_hi, u_lo, v_hi, v_lo;
  float bg[6];
};

// The sphere loop's inputs, as the wrappers pass them. The listed variant
// reads the (4, S) table and its block's list; the full variant reads the
// same table through the per-scene hierarchy of
// ops/cuda/sphere_kernel.py:build_sphere_bvh.
struct SphereArgs {
  const float* sph;  // (4, S) [cx, cy, cz, A = r^2 - |c|^2]
  int n_spheres;
  const int* lists;  // (n / 1024, list_k), listed variant only
  const int* counts;  // (n / 1024,)
  int list_k;
  const int* order;  // (n_order,) sphere indices, unconditional ones first
  const float4* nodes;  // (n_nodes,) [Cx, Cy, Cz, RL], full variant only:
  const int4* links;  // the n_groups groups, then the leaves [first, count]
  int n_order, n_uncond, n_nodes, n_groups;
};

// Shared memory the staged sphere loop takes per CTA.
inline size_t sphere_smem_bytes(const SphereArgs& a, bool listed) {
  return listed ? sizeof(float4) * (size_t)a.n_spheres
                : (sizeof(float4) + sizeof(int)) * (size_t)a.n_order +
                      (sizeof(float4) + sizeof(int4)) * (size_t)a.n_nodes;
}

// The staged copy in shared memory: sph[j] is float4 [cx, cy, cz, A], one
// broadcast 16-byte word per pair test. Listed: j is the sphere index. Full:
// j is a position of `order`, idx[j] its sphere index, and node / link
// hold the hierarchy.
struct SphereShared {
  const float4* sph;
  const int* idx;
  const float4* node;
  const int4* link;
};

// Copies the sphere words (exact copies of the table's, A is never
// recomputed) and, for the full variant, the hierarchy into shared memory.
// All threads of the CTA call it; it ends in a barrier.
template <bool LISTED>
__device__ __forceinline__ SphereShared stage_spheres(float4* smem,
                                                      const SphereArgs& a) {
  const int ns = a.n_spheres;
  SphereShared sh{smem, nullptr, nullptr, nullptr};
  if (LISTED) {
    for (int s = threadIdx.x; s < ns; s += blockDim.x) {
      smem[s] = make_float4(a.sph[s], a.sph[ns + s], a.sph[2 * ns + s],
                            a.sph[3 * ns + s]);
    }
  } else {
    float4* node_s = smem + a.n_order;
    int4* link_s = reinterpret_cast<int4*>(node_s + a.n_nodes);
    int* idx_s = reinterpret_cast<int*>(link_s + a.n_nodes);
    for (int j = threadIdx.x; j < a.n_order; j += blockDim.x) {
      const int s = __ldg(a.order + j);
      smem[j] = make_float4(a.sph[s], a.sph[ns + s], a.sph[2 * ns + s],
                            a.sph[3 * ns + s]);
      idx_s[j] = s;
    }
    for (int k = threadIdx.x; k < a.n_nodes; k += blockDim.x) {
      node_s[k] = a.nodes[k];
      link_s[k] = a.links[k];
    }
    sh = SphereShared{smem, idx_s, node_s, link_s};
  }
  __syncthreads();
  return sh;
}

// The cull's margin and its lanes' limits, and the most leaves a group holds
// (ops/cuda/sphere_kernel.py: CULL_SLOPE, DIR_TOL, ORG_Q_MAX,
// GROUP_LEAVES).
constexpr float CULL_SLOPE = 0x1p-7f;
constexpr float DIR_TOL = 0x1p-17f;
constexpr float ORG_Q_MAX = 0x1p100f;
constexpr int GROUP_LEAVES = 4;
constexpr int GROUP_BATCH = 8;  // group tests issued before their votes

// Nearest sphere of lane i's ray (o, d): the a*t key and the index, (BIG, 0)
// on a miss. ORIGIN_ZERO: the ray starts at the origin (bounce 0).
//
// The pair test. With g = A + 2 c.o - |o|^2 and bp = c.d - o.d, the key is
// at = bp + sq if g >= 0 and bp >= 0, else bp - sq, sq = sqrtf(g + bp^2),
// and a pair is taken when at >= 0 (NaN never is). Early reject: a pair
// with !(bp >= 0) or !(disc >= 0) skips the sqrt and the select, which
// changes no bit. If bp < 0, inside_pos is false and at = bp - sq, which
// is NaN or at most bp < 0 (rounding is monotone); if disc < 0 or NaN, sq
// and so at are NaN; either way `at >= 0` fails. bp = -0.0 passes
// bp >= 0, so it is tested (at = -0.0 - 0.0 = -0.0 is taken when disc is
// 0). After the reject bp >= 0 holds, so inside_pos is g >= 0.
//
// LISTED: the lane tests its 1024-ray block's list
// lists[i / 1024, :counts[i / 1024]] (global indices, ascending) with the
// strict `<` of an ascending scan: ties go to the lowest index.
//
// Full: the warp walks the two-level hierarchy. The unconditional spheres
// come first. Then every lane present runs the conservative test below on
// GROUP_BATCH groups at once (independent tests, so their latencies
// overlap), and the warp enters a group if any of them may hit under it
// (__any_sync over __activemask(): dead lanes have left, and a lane may
// test spheres its own test would skip, which is harmless). In an entered
// group the lanes test its leaves at once, and the warp tests the spheres
// of each leaf that any lane may hit. Since the visit order is not the
// index order, a pair is taken by the (key, index) rule
// `at >= 0 && (at < best || (at == best && s < best_idx))` from (BIG, 0):
// the lexicographic minimum over the pairs tested, which is the strict-`<`
// ascending scan over all S spheres (the plain version's torch.min: first
// index among equal minima, (BIG, 0) on a miss) as long as no skipped
// pair would have been taken. Each sphere sits in one leaf or in the
// unconditional set, so no pair is tested twice.
//
// Why no skipped pair would have been taken. Let u = 2^-24, m =
// CULL_SLOPE = 2^-7 (m^2 = 1024 u), L = |c| + r + |o| with r^2 = A + |c|^2
// the radius the float A implies, and |d|^2 = 1 + delta. Round-off bounds
// of the float pair test (every product and sum rounded, -fmad=false):
// bp within 4.1 u L and disc within 21 u L^2 of their exact values, and
// the exact disc is r^2 - p^2 + delta (w.d/|d|)^2, p the distance from c
// to the ray's line and w = c - o. So a taken pair has p^2 <= r^2 +
// (21 u + |delta|) L^2 and bp >= -4.1 u L. A node's (a group's or a
// leaf's) bound (C, R) holds each sphere under it (|c - C| + r <= R, so
// L <= L_C = |C| + R + |o|),
// and its float test is within (16 u + |delta|) L_C^2 of the exact
// p_C^2 = |C - o|^2 - (w_C.d)^2 / |d|^2. The lane skips the node only if
// q - b^2 > lim^2 or b < -lim, with lim = RL + m |o| >= (R + m L_C)
// (1 - 3.6 u) (RL = R + m (|C| + R) rounded up on the host). A taken pair
// under it gives p_C <= R + sqrt(21 u + |delta|) L_C, and with |delta| <=
// DIR_TOL + 4 u = 132 u, 1024 u - (21 + 16) u - 2 |delta| leaves 723 u of
// m^2 to spare, so the node passes both compares. Lanes the bounds do not
// cover enter every node: |a2 - 1| > DIR_TOL, |o|^2 >= ORG_Q_MAX, or NaN.
// The host puts spheres that are not finite or lie past 2^50, and those
// larger than the rest of the scene (shirley's ground, r = 1000, whose g
// cancels ~1e6 against ~1e6), in the unconditional set; pads (A = -BIG,
// |c| < 2^50) can never be taken by a covered lane and are in no leaf.
template <bool LISTED, bool ORIGIN_ZERO>
__device__ __forceinline__ void nearest_sphere(
    const SphereShared& sh, const SphereArgs& a, int i, const float o[3],
    const float d[3], float& best_at, int& best_idx) {
  const float o0 = o[0], o1 = o[1], o2 = o[2];
  const float d0 = d[0], d1 = d[1], d2 = d[2];
  float od = 0.0f, oq = 0.0f;
  if (!ORIGIN_ZERO) {
    od = o0 * d0 + o1 * d1 + o2 * d2;
    oq = o0 * o0 + o1 * o1 + o2 * o2;
  }
  best_at = BIG;
  best_idx = 0;
  auto test = [&](const float4 sp, int s) {
    float bp, g;
    if (ORIGIN_ZERO) {
      bp = sp.x * d0 + sp.y * d1 + sp.z * d2;
      g = sp.w;
    } else {
      bp = sp.x * d0 + sp.y * d1 + sp.z * d2 - od;
      g = sp.w + 2.0f * (sp.x * o0 + sp.y * o1 + sp.z * o2) - oq;
    }
    const float disc = g + bp * bp;
    if (!(bp >= 0.0f) || !(disc >= 0.0f)) return;  // early reject
    const float sq = sqrtf(disc);
    const float at = bp + ((g >= 0.0f) ? sq : -sq);
    const bool take =
        LISTED ? (at < best_at) && (at >= 0.0f)
               : (at >= 0.0f) &&
                     (at < best_at || (at == best_at && s < best_idx));
    if (take) {
      best_at = at;
      best_idx = s;
    }
  };
  if (LISTED) {
    const int blk = i / RAY_BLOCK;
    const int cnt = min(__ldg(a.counts + blk), a.list_k);
    const int* lst = a.lists + (size_t)blk * a.list_k;
    for (int j = 0; j < cnt; ++j) {
      const int s = __ldg(lst + j);
      test(sh.sph[s], s);
    }
    return;
  }
  const unsigned mask = __activemask();
  const float a2 = d0 * d0 + d1 * d1 + d2 * d2;
  const bool every = !(fabsf(a2 - 1.0f) <= DIR_TOL) || !(oq <= ORG_Q_MAX);
  const float mon = ORIGIN_ZERO ? 0.0f : CULL_SLOPE * sqrtf(oq);
  // whether the lane may hit a sphere under node k
  auto may_hit = [&](int k) {
    const float4 nb = sh.node[k];
    const float w0 = ORIGIN_ZERO ? nb.x : nb.x - o0;
    const float w1 = ORIGIN_ZERO ? nb.y : nb.y - o1;
    const float w2 = ORIGIN_ZERO ? nb.z : nb.z - o2;
    const float b = w0 * d0 + w1 * d1 + w2 * d2;
    const float q = w0 * w0 + w1 * w1 + w2 * w2;
    const float lim = nb.w + mon;
    return every | (!(q - b * b > lim * lim) & !(b < -lim));
  };
  for (int j = 0; j < a.n_uncond; ++j) test(sh.sph[j], sh.idx[j]);
  for (int g0 = 0; g0 < a.n_groups; g0 += GROUP_BATCH) {
    unsigned mine = 0;  // bit u: this lane may hit under group g0 + u
#pragma unroll
    for (int u = 0; u < GROUP_BATCH; ++u) {
      const int g = min(g0 + u, a.n_groups - 1);
      mine |= (unsigned)(may_hit(g) & (g0 + u < a.n_groups)) << u;
    }
    unsigned groups = 0;  // bit u: the warp enters group g0 + u
#pragma unroll
    for (int u = 0; u < GROUP_BATCH; ++u)
      groups |= (unsigned)__any_sync(mask, (mine >> u) & 1u) << u;
    while (groups != 0) {
      const int4 gl = sh.link[g0 + __ffs(groups) - 1];
      groups &= groups - 1;
      unsigned lmine = 0;
#pragma unroll
      for (int v = 0; v < GROUP_LEAVES; ++v) {
        const int leaf = gl.x + min(v, gl.y - 1);
        lmine |= (unsigned)(may_hit(leaf) & (v < gl.y)) << v;
      }
      unsigned leaves = 0;
#pragma unroll
      for (int v = 0; v < GROUP_LEAVES; ++v)
        leaves |= (unsigned)__any_sync(mask, (lmine >> v) & 1u) << v;
      while (leaves != 0) {
        const int4 ll = sh.link[gl.x + __ffs(leaves) - 1];
        leaves &= leaves - 1;
        for (int j = ll.x; j < ll.x + ll.y; ++j) test(sh.sph[j], sh.idx[j]);
      }
    }
  }
}

__device__ __forceinline__ float jmax(float x, float c) {
  return (x != x || x > c) ? x : c;  // NaN-propagating max
}
__device__ __forceinline__ float jmin(float x, float c) {
  return (x != x || x < c) ? x : c;
}

__device__ __forceinline__ float atan_poly(float z) {
  float t = z * z;
  float p = -0x1.bd82d4p-10f;
  p = p * t + 0x1.57e496p-7f;
  p = p * t + -0x1.f1f912p-6f;
  p = p * t + 0x1.d445aep-5f;
  p = p * t + -0x1.56417cp-4f;
  p = p * t + 0x1.bfe736p-4f;
  p = p * t + -0x1.240f2p-3f;
  p = p * t + 0x1.998feep-3f;
  p = p * t + -0x1.555532p-2f;
  p = p * t + 1.0f;
  return z * p;
}

__device__ __forceinline__ float atan2_poly(float y, float x) {
  float ax = fabsf(x), ay = fabsf(y);
  bool swap = ay > ax;
  float num = swap ? ax : ay;
  float den = swap ? ay : ax;
  float r = atan_poly(num / jmax(den, TINY30));
  r = swap ? HALF_PI_F - r : r;
  r = (x < 0.0f) ? PI_F - r : r;
  return (y < 0.0f) ? -r : r;
}

__device__ __forceinline__ float acos_poly(float x) {
  float s = sqrtf(jmax((1.0f - x) * (1.0f + x), 0.0f));
  return atan2_poly(s, x);
}

// Fixed-point Roberts draw, in-kernel conversion f32(int32(v >> 1)) * 2^-31.
__device__ __forceinline__ float lds(uint32_t off, uint32_t hi, uint32_t lo) {
  uint32_t m = off + 1u;
  uint32_t p0 = lo & 0xFFFFu, p1 = lo >> 16;
  uint32_t q0 = m & 0xFFFFu, q1 = m >> 16;
  uint32_t pp0 = p0 * q0, pp1a = p0 * q1, pp1b = p1 * q0;
  uint32_t t1 = pp0 + (pp1a << 16);
  uint32_t c1 = t1 < pp0 ? 1u : 0u;
  uint32_t t2 = t1 + (pp1b << 16);
  uint32_t c2 = t2 < t1 ? 1u : 0u;
  uint32_t hw = hi * m + p1 * q1 + (pp1a >> 16) + (pp1b >> 16) + c1 + c2;
  uint32_t v = hw + 0x80000000u;
  float s = (float)(int32_t)(v >> 1) * LDS_SCALE;
  return fminf(s, ONE_MINUS_EPS);
}

__device__ __forceinline__ void rot(float qw, float qx, float qy, float v0,
                                    float v1, float v2, bool inv, float& w0,
                                    float& w1, float& w2) {
  float rx = inv ? -qx : qx;
  float ry = inv ? -qy : qy;
  float t0 = 2.0f * (ry * v2);
  float t1 = 2.0f * (-rx * v2);
  float t2 = 2.0f * (rx * v1 - ry * v0);
  w0 = v0 + qw * t0 + (ry * t2);
  w1 = v1 + qw * t1 + (-rx * t2);
  w2 = v2 + qw * t2 + (rx * t1 - ry * t0);
}

__device__ __forceinline__ float f15(uint32_t u) {
  return (float)(int32_t)(u & 0x7FFFu) * C15;
}

// Shading of one live lane that hit sphere `idx` (shade_kernel.shade).
__device__ __forceinline__ void shade_lane(const ShadeArgs& p, int i, int idx,
                                           const float o[3], const float d[3],
                                           const float a[3], float out[10]) {
  const float d0 = d[0], d1 = d[1], d2 = d[2];
  const float o0 = o[0], o1 = o[1], o2 = o[2];
  float a_q = d0 * d0 + d1 * d1 + d2 * d2;
  float inv_a = 1.0f / a_q;

  float pk[10];
#pragma unroll
  for (int c = 0; c < 10; ++c) pk[c] = __ldg(p.pack + c * p.pack_stride + idx);
  float cx = pk[0], cy = pk[1], cz = pk[2], rad_s = pk[3];
  float ior = pk[4], cw = pk[5], ch = pk[6];
  float ior_inv = 1.0f / jmax(ior, TINY30);
  uint32_t u0 = __float_as_uint(pk[7]);
  uint32_t u1 = __float_as_uint(pk[8]);
  uint32_t u2 = __float_as_uint(pk[9]);
  float ca0 = f15(u0), ca1 = f15(u0 >> 15);
  float ca2 = f15(u1), cb0 = f15(u1 >> 15);
  float cb1 = (float)(int32_t)(u2 & 0xFFFFu) * C16;
  float cb2 = (float)(int32_t)(u2 >> 16) * C16;
  uint32_t mat_u = u0 >> 30, tex_u = u1 >> 30;

  // stable t from the winner's params
  float f0 = cx - o0, f1 = cy - o1, f2 = cz - o2;
  float bp = f0 * d0 + f1 * d1 + f2 * d2;
  float quad_f = f0 * f0 + f1 * f1 + f2 * f2;
  float r2 = rad_s * rad_s;
  float c_c = quad_f - r2;
  float disc = r2 - quad_f + bp * bp * inv_a;
  float sgn = (bp >= 0.0f) ? 1.0f : -1.0f;
  float qq = sgn * sqrtf(jmax(a_q * disc, 0.0f)) + bp;
  float t = (c_c > 0.0f) ? c_c / qq : qq * inv_a;

  // hit point + flipped normal
  float p0 = o0 + t * d0, p1 = o1 + t * d1, p2 = o2 + t * d2;
  float n0 = p0 - cx, n1 = p1 - cy, n2 = p2 - cz;
  float ninv = 1.0f / sqrtf(jmax(n0 * n0 + n1 * n1 + n2 * n2, TINY38));
  n0 = n0 * ninv;
  n1 = n1 * ninv;
  n2 = n2 * ninv;
  float ddn = d0 * n0 + d1 * n1 + d2 * n2;
  bool front = ddn < 0.0f;
  float fs = front ? 1.0f : -1.0f;
  n0 = n0 * fs;
  n1 = n1 * fs;
  n2 = n2 * fs;

  // spherical uv, checker parity
  float theta = acos_poly(jmin(jmax(-n1, -1.0f), 1.0f));
  float phi = PI_F + atan2_poly(-n2, n0);
  float u_t = phi * TWO_PI_INV_F;
  float v_t = theta * PI_INV_F;
  int pxp = ((int)truncf(u_t * cw)) & 1;
  int pyp = ((int)truncf(v_t * ch)) & 1;
  bool odd = (tex_u == 1u) && (pxp != pyp);
  float alb0 = odd ? cb0 : ca0;
  float alb1 = odd ? cb1 : ca1;
  float alb2 = odd ? cb2 : ca2;

  // tangent frame quaternion
  float gw = 1.0f + n2;
  float gnorm = 1.0f / sqrtf(jmax(gw * gw + n1 * n1 + n0 * n0, TINY38));
  float qw = gw * gnorm;
  float qx = n1 * gnorm;
  float qy = -n0 * gnorm;
  bool top = n2 > POLE_TOP;
  bool bot = n2 < POLE_BOT;
  qw = top ? 1.0f : (bot ? 0.0f : qw);
  qx = (top || bot) ? 0.0f : qx;
  qy = top ? 0.0f : (bot ? 1.0f : qy);

  float wi0, wi1, wi2;
  rot(qw, qx, qy, -d0, -d1, -d2, false, wi0, wi1, wi2);

  uint32_t offv = p.off[i];
  float u = lds(offv, p.u_hi, p.u_lo);
  float v = lds(offv, p.v_hi, p.v_lo);

  // lambertian: cosine hemisphere
  float rr = sqrtf(u);
  float th = v * TWO_PI_F;
  float lam0 = rr * cosf(th);
  float lam1 = rr * sinf(th);
  float lam2 = sqrtf(jmax(1.0f - u, 0.0f));
  bool lam_ok = lam2 > 0.0f;
  // metal: mirror + Schlick tint
  float met0 = -wi0, met1 = -wi1, met2 = wi2;
  bool met_ok = met2 > 0.0f;
  float s5 = 1.0f - wi2;
  s5 = s5 * s5 * s5 * s5 * s5;
  float tn0 = alb0 + (1.0f - alb0) * s5;
  float tn1 = alb1 + (1.0f - alb1) * s5;
  float tn2 = alb2 + (1.0f - alb2) * s5;
  // dielectric
  float ci = jmin(jmax(wi2, 0.0f), 1.0f);
  float si = sqrtf(jmax(1.0f - ci * ci, 0.0f));
  float ratio = front ? ior_inv : ior;
  float r0s = (1.0f - ratio) / (1.0f + ratio);
  r0s = r0s * r0s;
  float omc = 1.0f - ci;
  float omc5 = omc * omc * omc * omc * omc;
  float schl = r0s + (1.0f - r0s) * omc5;
  bool do_refl = (ratio * si > 1.0f) || (schl > u);
  float cc = jmin(wi2, 1.0f);
  float pe0 = ratio * (-wi0);
  float pe1 = ratio * (-wi1);
  float pe2 = ratio * (cc - wi2);
  float para = -sqrtf(fabsf(1.0f - (pe0 * pe0 + pe1 * pe1 + pe2 * pe2)));
  float die0 = do_refl ? met0 : pe0;
  float die1 = do_refl ? met1 : pe1;
  float die2 = do_refl ? met2 : pe2 + para;

  bool is_met = mat_u == 1u;
  bool is_die = mat_u == 2u;
  float wo0 = is_die ? die0 : (is_met ? met0 : lam0);
  float wo1 = is_die ? die1 : (is_met ? met1 : lam1);
  float wo2 = is_die ? die2 : (is_met ? met2 : lam2);
  float am0 = is_die ? 1.0f : (is_met ? tn0 : alb0);
  float am1 = is_die ? 1.0f : (is_met ? tn1 : alb1);
  float am2 = is_die ? 1.0f : (is_met ? tn2 : alb2);
  bool ok = is_die || (is_met && met_ok) || (!is_die && !is_met && lam_ok);

  // world ray with the shadow-acne offset
  float dw0, dw1, dw2;
  rot(qw, qx, qy, wo0, wo1, wo2, true, dw0, dw1, dw2);
  if (ok) {
    out[0] = p0 + SHADOW * dw0;
    out[1] = p1 + SHADOW * dw1;
    out[2] = p2 + SHADOW * dw2;
    out[3] = dw0;
    out[4] = dw1;
    out[5] = dw2;
    out[6] = a[0] * am0;
    out[7] = a[1] * am1;
    out[8] = a[2] * am2;
    out[9] = 1.0f;
  } else {
    out[0] = o0;
    out[1] = o1;
    out[2] = o2;
    out[3] = d0;
    out[4] = d1;
    out[5] = d2;
    out[6] = a[0];
    out[7] = a[1];
    out[8] = a[2];
    out[9] = 0.0f;
  }
}

// A dead lane: state and radiance pass through unchanged.
__device__ __forceinline__ void pass_through(int i, int n, const float st[10],
                                             const float r_in[3],
                                             float* st_out, float* rad_out) {
#pragma unroll
  for (int c = 0; c < 10; ++c) st_out[c * n + i] = st[c];
#pragma unroll
  for (int c = 0; c < 3; ++c) rad_out[c * n + i] = r_in[c];
}

// The end of a live lane's bounce, given its intersection (hit, idx): a
// miss adds attn * background to the radiance (the sky gradient over d.y
// when BG_MODE is 1, else the solid row 0) and kills the lane; a hit is
// shaded. Writes the lane's state (10, n) and radiance (3, n).
template <int BG_MODE>
__device__ __forceinline__ void shade_store(const ShadeArgs& p, int i, int n,
                                            bool hit, int idx,
                                            const float st[10],
                                            const float r_in[3],
                                            float* st_out, float* rad_out) {
  const float a[3] = {st[6], st[7], st[8]};
  if (!hit) {
    float b0, b1, b2;
    if (BG_MODE == 1) {
      float tt = 0.5f * (st[4] + 1.0f);
      b0 = p.bg[0] * (1.0f - tt) + p.bg[3] * tt;
      b1 = p.bg[1] * (1.0f - tt) + p.bg[4] * tt;
      b2 = p.bg[2] * (1.0f - tt) + p.bg[5] * tt;
    } else {
      b0 = p.bg[0];
      b1 = p.bg[1];
      b2 = p.bg[2];
    }
    rad_out[i] = r_in[0] + a[0] * b0;
    rad_out[n + i] = r_in[1] + a[1] * b1;
    rad_out[2 * n + i] = r_in[2] + a[2] * b2;
#pragma unroll
    for (int c = 0; c < 9; ++c) st_out[c * n + i] = st[c];
    st_out[9 * n + i] = 0.0f;
    return;
  }
  const float o[3] = {st[0], st[1], st[2]};
  const float d[3] = {st[3], st[4], st[5]};
  float out[10];
  shade_lane(p, i, idx, o, d, a, out);
#pragma unroll
  for (int c = 0; c < 10; ++c) st_out[c * n + i] = out[c];
#pragma unroll
  for (int c = 0; c < 3; ++c) rad_out[c * n + i] = r_in[c] + 0.0f;
}

}  // namespace
