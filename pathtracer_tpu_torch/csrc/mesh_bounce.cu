// The mesh path tracer's bounce after its intersectors, for Hopper
// (sm_90a): two kernels over the lanes of integrator.trace.
//
// Replaces no TPU kernel: the JAX trace's composite tier is XLA glue, and
// the port ran it as ~480 eager PyTorch operations a bounce over every
// lane, two thirds of them dead. The plain PyTorch version of both
// kernels is integrator.composite_hits (the combine of Intersector's
// hit_setup) followed by integrator.scatter_bounce (trace_plain's sky,
// sampler draws, shading.scatter and updates); the outputs equal it
// exactly. Wrappers: ops/cuda/mesh_bounce_kernel.py.
//
//  - winner_t_kernel, before the mesh query: each lane's pools' winner t
//    (the sphere winner's stable t, the triangle choice), BIG where
//    neither pool hits: the mesh walk's cap, as composite_hits' t_cur.
//  - mesh_bounce_kernel, after it: a dead lane counts nothing and returns
//    after reading its alive byte. A live lane adds itself to the bounce's
//    segments (one atomic per warp), selects the winner among sphere,
//    triangle and mesh, then on a miss adds attn * sky to its radiance and
//    dies; on a hit it computes only the winner's point, normal, uv and
//    texture albedo, the tangent-frame quaternion, the two sampler draws,
//    every material branch of the scatter, the world direction and the
//    offset origin, and writes org, d, attn (or its death) in place.
//
// Numerics, kept equal to the plain version: built with -fmad=false and
// without fast math (IEEE division and sqrtf); every sum is taken in the
// plain version's order, each torch operation one rounding. vec.normalize
// and quat.normalize scale by 1/sqrt rounded once from double
// (vec.inv_sqrt), not by 1.0f / sqrtf. acosf, atan2f, cosf and sinf are
// CUDA's, as torch's CUDA kernels call them. torch.clamp propagates NaN and
// is otherwise fminf / fmaxf (clamp_min, clamp_max, clamp_nan). The
// sampler draw takes the top word of the 64-bit product (alpha_hi * 2^32 +
// alpha_lo) * (offset + 1), which ops/lds.py:hi_word emulates in 16-bit
// limbs. Selects pick one branch, so a lane computes only its winner's
// attributes; the quaternion keeps its zero z component, as quat.rotate
// does, so each zero keeps its sign.
//
// Bound on this card: bytes. A live lane reads ~110 B (its state, offset,
// pool and mesh winners) plus a winner row through the read-only
// cache and writes ~40 B; ~150 B a lane in all, ~55 MB a bounce of
// 365,568 lanes if all were live, ~16 µs at 3.35 TB/s. The dead lanes read
// one byte. Left for later PRs: the primaries' draws, and the PPM photon
// bounce, whose body (deposits, Russian roulette) differs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pt_bounce.cuh"

namespace {

constexpr int MB_THREADS = 256;
constexpr float DRAW_SCALE = 0x1p-32f;

// What both kernels read of the pools: intersect_spheres' (at, idx, inv_a)
// and intersect_tris' (t, idx) per lane, and the scene's (S, 16) shade
// pack and (T, 27) triangle pack (tri_t null: no triangle pool).
struct Pools {
  const float* at;
  const int* idx_s;
  const float* inv_a;
  const float* tri_t;
  const int* idx_t;
  const float* shade_pack;
  const float* tri_pack;
};

struct Winner {
  float t_s, t_t, t_cur;
  bool use_tri, hit;
};

// torch.clamp with min, max or both: NaN stays NaN, else fmaxf / fminf
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// vec.inv_sqrt: 1 / sqrt(x) in double, rounded once
__device__ __forceinline__ float inv_sqrt(float x) {
  return (float)(1.0 / sqrt((double)x));
}

__device__ __forceinline__ void normalize3(float v[3]) {
  const float s = inv_sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  v[0] = v[0] * s;
  v[1] = v[1] * s;
  v[2] = v[2] * s;
}

// vec.cross
__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// quat.rotate: v + 2 (q.v x v) w + q.v x (2 q.v x v), q = [w, x, y, z]
__device__ __forceinline__ void rotate(const float q[4], const float v[3],
                                       float r[3]) {
  const float qv[3] = {q[1], q[2], q[3]};
  float t[3], c[3];
  cross3(qv, v, t);
  t[0] = 2.0f * t[0];
  t[1] = 2.0f * t[1];
  t[2] = 2.0f * t[2];
  cross3(qv, t, c);
  r[0] = v[0] + t[0] * q[0] + c[0];
  r[1] = v[1] + t[1] * q[0] + c[1];
  r[2] = v[2] + t[2] * q[0] + c[2];
}

// ops/lds.py:sample_fixed
__device__ __forceinline__ float draw(uint32_t off, uint32_t a_hi,
                                      uint32_t a_lo) {
  const uint64_t alpha = ((uint64_t)a_hi << 32) | a_lo;
  const uint32_t m = off + 1u;
  const uint32_t v = (uint32_t)((alpha * (uint64_t)m) >> 32) + 0x80000000u;
  return fminf((float)v * DRAW_SCALE, ONE_MINUS_EPS);
}

// composite_hits up to t_cur: the sphere winner's stable t
// (ops/spheres.py:stable_t), the triangle choice and the pools' hit
__device__ __forceinline__ Winner pool_winner(const Pools& p, int i,
                                              const float o[3],
                                              const float d[3]) {
  Winner w;
  const float* pk = p.shade_pack + 16 * __ldg(p.idx_s + i);
  const float inv_a = __ldg(p.inv_a + i);
  const float a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const float r_h = __ldg(pk + 3);
  const float r2 = r_h * r_h;
  const float f0 = __ldg(pk) - o[0], f1 = __ldg(pk + 1) - o[1],
              f2 = __ldg(pk + 2) - o[2];
  const float bp = f0 * d[0] + f1 * d[1] + f2 * d[2];
  const float quad_f = f0 * f0 + f1 * f1 + f2 * f2;
  const float c = quad_f - r2;
  const float disc = r2 - quad_f + bp * bp * inv_a;
  const float sgn = (bp >= 0.0f) ? 1.0f : -1.0f;
  const float q = sgn * sqrtf(clamp_min(a * disc, 0.0f)) + bp;
  w.t_s = (c > 0.0f) ? c / q : q * inv_a;
  const bool hit_s = __ldg(p.at + i) < BIG;
  if (p.tri_t != nullptr) {
    w.t_t = __ldg(p.tri_t + i);
    const bool hit_t = w.t_t < BIG;
    w.use_tri = hit_t && (!hit_s || (w.t_t < w.t_s));
    w.hit = hit_s || hit_t;
  } else {
    w.t_t = BIG;
    w.use_tri = false;
    w.hit = hit_s;
  }
  w.t_cur = w.hit ? (w.use_tri ? w.t_t : w.t_s) : BIG;
  return w;
}

__global__ void __launch_bounds__(MB_THREADS)
    winner_t_kernel(Pools p, const float* __restrict__ org,
                    const float* __restrict__ dir, float* __restrict__ t_cur,
                    int n) {
  const int i = blockIdx.x * MB_THREADS + threadIdx.x;
  if (i >= n) return;
  const float o[3] = {org[3 * i], org[3 * i + 1], org[3 * i + 2]};
  const float d[3] = {dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]};
  t_cur[i] = pool_winner(p, i, o, d).t_cur;
}

// The mesh query's hits (t, u, v, idx, hit) per lane, the mesh's (9, T)
// [a | e1 | e2] pack and its 12-column material row.
struct MeshHits {
  const float* t;
  const float* u;
  const float* v;
  const int* idx;
  const uint8_t* hit;
  const float* pack9;
  int n_tris;
  const float* mat_row;
};

// The lanes' state, updated in place, and what the shading reads.
struct Lanes {
  float* org;  // (n, 3)
  float* dir;  // (n, 3)
  float* attn;  // (n, 3)
  float* rad;  // (n, 3)
  uint8_t* alive;  // (n,)
  const int64_t* offset;  // (n,)
  const float* sky;  // (2, 3): the colours at d.y = -1 and +1
  uint32_t u_hi, u_lo, v_hi, v_lo;  // this bounce's sampler limbs
  unsigned long long* segments;
  int n;
};

__global__ void __launch_bounds__(MB_THREADS)
    mesh_bounce_kernel(Pools p, MeshHits m, Lanes s) {
  const int i = blockIdx.x * MB_THREADS + threadIdx.x;
  const bool live = i < s.n && s.alive[i] != 0;
  const unsigned votes = __ballot_sync(0xffffffffu, live);
  if ((threadIdx.x & 31) == 0 && votes != 0)
    atomicAdd(s.segments, (unsigned long long)__popc(votes));
  if (!live) return;

  const float o[3] = {s.org[3 * i], s.org[3 * i + 1], s.org[3 * i + 2]};
  const float d[3] = {s.dir[3 * i], s.dir[3 * i + 1], s.dir[3 * i + 2]};
  const float at[3] = {s.attn[3 * i], s.attn[3 * i + 1], s.attn[3 * i + 2]};
  const Winner w = pool_winner(p, i, o, d);
  const bool hit_m = m.hit[i] != 0;
  const bool use_mesh = hit_m && m.t[i] < w.t_cur;
  const bool use_tri = w.use_tri && !use_mesh;

  if (!(w.hit || hit_m)) {  // the sky, then the lane dies
    const float tt = 0.5f * (d[1] + 1.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float sky_c = s.sky[c] * (1.0f - tt) + s.sky[3 + c] * tt;
      s.rad[3 * i + c] = s.rad[3 * i + c] + at[c] * sky_c;
    }
    s.alive[i] = 0;
    return;
  }

  // the winner's point, geometric normal, tex coords and material row
  float pt[3], g[3], u_tex = 0.0f, v_tex = 0.0f;
  const float* mat;
  bool uv_set = true;
  if (use_mesh) {
    const int k = m.idx[i];
    const int nt = m.n_tris;
    float ma[3], e1[3], e2[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ma[c] = __ldg(m.pack9 + c * nt + k);
      e1[c] = __ldg(m.pack9 + (3 + c) * nt + k);
      e2[c] = __ldg(m.pack9 + (6 + c) * nt + k);
    }
    const float u_m = m.u[i], v_m = m.v[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) pt[c] = ma[c] + u_m * e1[c] + v_m * e2[c];
    cross3(e1, e2, g);
    normalize3(g);
    u_tex = v_m;  // the mesh's fixed (t00, t01, t11) tex corners
    v_tex = u_m + v_m;
    mat = m.mat_row;
  } else if (use_tri) {
    const float* tr = p.tri_pack + 27 * __ldg(p.idx_t + i);
    float a[3], e1[3], e2[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[c] = __ldg(tr + c);
      e1[c] = __ldg(tr + 3 + c);
      e2[c] = __ldg(tr + 6 + c);
    }
    // ops/triangles.py:mt_single's u, v
    float pv[3], tv[3], qv[3];
    cross3(d, e2, pv);
    const float det_inv = 1.0f / (e1[0] * pv[0] + e1[1] * pv[1] +
                                  e1[2] * pv[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) tv[c] = o[c] - a[c];
    const float u_b = det_inv * (tv[0] * pv[0] + tv[1] * pv[1] +
                                 tv[2] * pv[2]);
    cross3(tv, e1, qv);
    const float v_b = det_inv * (d[0] * qv[0] + d[1] * qv[1] + d[2] * qv[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) pt[c] = a[c] + u_b * e1[c] + v_b * e2[c];
    cross3(e1, e2, g);
    normalize3(g);
    const float w_b = 1.0f - u_b - v_b;
    u_tex = __ldg(tr + 9) * w_b + __ldg(tr + 11) * u_b + __ldg(tr + 13) * v_b;
    v_tex = __ldg(tr + 10) * w_b + __ldg(tr + 12) * u_b +
            __ldg(tr + 14) * v_b;
    mat = tr + 15;
  } else {
    const float* pk = p.shade_pack + 16 * __ldg(p.idx_s + i);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pt[c] = o[c] + w.t_s * d[c];
      g[c] = pt[c] - __ldg(pk + c);
    }
    normalize3(g);
    mat = pk + 4;
    uv_set = false;  // from the flipped normal, below
  }
  const bool front = d[0] * g[0] + d[1] * g[1] + d[2] * g[2] < 0.0f;
  const float n[3] = {front ? g[0] : -g[0], front ? g[1] : -g[1],
                      front ? g[2] : -g[2]};
  if (!uv_set) {  // sphere uv from the flipped normal
    const float ny = clamp_nan(n[1], -1.0f, 1.0f);
    u_tex = (PI_F + atan2f(-n[2], n[0])) * TWO_PI_INV_F;
    v_tex = acosf(-ny) * PI_INV_F;
  }

  // scene.eval_texture
  float mr[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) mr[c] = __ldg(mat + c);
  const int px = (int)truncf(u_tex * mr[8]) & 1;
  const int py = (int)truncf(v_tex * mr[9]) & 1;
  const bool col_b = mr[1] == 1.0f && px != py;
  const float alb[3] = {col_b ? mr[5] : mr[2], col_b ? mr[6] : mr[3],
                        col_b ? mr[7] : mr[4]};

  // shading.shader_quat
  float q[4];
  {
    const float qw = 1.0f + n[2], qx = n[1], qy = -n[0], qz = 0.0f;
    const float sc = inv_sqrt(qw * qw + qx * qx + qy * qy + qz * qz);
    q[0] = qw * sc;
    q[1] = qx * sc;
    q[2] = qy * sc;
    q[3] = qz * sc;
    if (n[2] > POLE_TOP) {
      q[0] = 1.0f;
      q[1] = q[2] = q[3] = 0.0f;
    }
    if (n[2] < -POLE_TOP) {
      q[0] = q[1] = q[3] = 0.0f;
      q[2] = 1.0f;
    }
  }
  const float minus_d[3] = {-d[0], -d[1], -d[2]};
  float wi[3];
  rotate(q, minus_d, wi);
  const uint32_t off = (uint32_t)s.offset[i];
  const float u = draw(off, s.u_hi, s.u_lo);
  const float v = draw(off, s.v_hi, s.v_lo);

  // shading.scatter: every branch, then the material's
  const float rr = sqrtf(u);
  const float th = v * TWO_PI_F;
  const float lam[3] = {rr * cosf(th), rr * sinf(th), sqrtf(1.0f - u)};
  const bool lam_ok = lam[2] > 0.0f;
  const float met[3] = {-wi[0], -wi[1], wi[2]};
  const bool met_ok = met[2] > 0.0f;
  const float pw = 1.0f - wi[2];
  const float pw2 = pw * pw;
  const float pw5 = pw * (pw2 * pw2);
  const float tint[3] = {alb[0] + (1.0f - alb[0]) * pw5,
                         alb[1] + (1.0f - alb[1]) * pw5,
                         alb[2] + (1.0f - alb[2]) * pw5};
  const float ci = clamp_nan(wi[2], 0.0f, 1.0f);
  const float si = sqrtf(1.0f - ci * ci);
  const float ratio = front ? mr[11] : mr[10];
  const float rs = (1.0f - ratio) / (1.0f + ratio);
  const float r0 = rs * rs;
  const float oc = 1.0f - ci;
  const float oc2 = oc * oc;
  const float schl = r0 + (1.0f - r0) * (oc * (oc2 * oc2));
  const bool refl = (ratio * si > 1.0f) || (schl > u);
  const float cc = clamp_max(wi[2], 1.0f);
  const float pe[3] = {(0.0f - wi[0]) * ratio, (0.0f - wi[1]) * ratio,
                       (cc - wi[2]) * ratio};
  const float para =
      -sqrtf(fabsf(1.0f - (pe[0] * pe[0] + pe[1] * pe[1] + pe[2] * pe[2])));
  const float die[3] = {refl ? met[0] : pe[0] + 0.0f,
                        refl ? met[1] : pe[1] + 0.0f,
                        refl ? met[2] : pe[2] + para};
  const bool is_met = mr[0] == 1.0f;
  const bool is_die = mr[0] == 2.0f;
  const bool ok = is_die || (is_met ? met_ok : lam_ok);
  if (!ok) {
    s.alive[i] = 0;
    return;
  }
  float wo[3], am[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    wo[c] = is_die ? die[c] : (is_met ? met[c] : lam[c]);
    am[c] = is_die ? 1.0f : (is_met ? tint[c] : alb[c]);
  }

  // quat.rotate_inv, shading.world_ray, the updates
  const float qc[4] = {q[0], -q[1], -q[2], -q[3]};
  float dw[3];
  rotate(qc, wo, dw);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.org[3 * i + c] = pt[c] + SHADOW * dw[c];
    s.dir[3 * i + c] = dw[c];
    s.attn[3 * i + c] = at[c] * am[c];
  }
}

}  // namespace

extern "C" {

// org, dir (n, 3); t_cur (n,); the pools' per-lane outputs (n,); shade
// pack (S, 16); tri_t, idx_t, tri_pack null without a triangle pool.
// Returns the cudaError_t of the launch.
int pt_winner_t(const float* at, const int* idx_s, const float* inv_a,
                const float* tri_t, const int* idx_t, const float* shade_pack,
                const float* tri_pack, const float* org, const float* dir,
                float* t_cur, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Pools p{at, idx_s, inv_a, tri_t, idx_t, shade_pack, tri_pack};
  const int grid = (n + MB_THREADS - 1) / MB_THREADS;
  winner_t_kernel<<<grid, MB_THREADS, 0, (cudaStream_t)stream>>>(p, org, dir,
                                                                 t_cur, n);
  return (int)cudaGetLastError();
}

// The pools as pt_winner_t's; the mesh query's t, u, v, idx (n,) and hit
// (n,) bool, the mesh's (9, n_tris) pack and (12,) material row; the
// lanes' org, dir, attn, rad (n, 3) and alive (n,) bool, updated in place;
// offset (n,) int64, sky (2, 3), the bounce's sampler limbs
// and segments (an int64 the live lanes are added to). Returns the
// cudaError_t of the launch.
int pt_mesh_bounce(const float* at, const int* idx_s, const float* inv_a,
                   const float* tri_t, const int* idx_t,
                   const float* shade_pack, const float* tri_pack,
                   const float* mesh_t, const float* mesh_u,
                   const float* mesh_v, const int* mesh_idx,
                   const uint8_t* mesh_hit, const float* pack9, int n_tris,
                   const float* mat_row, float* org, float* dir, float* attn,
                   float* rad, uint8_t* alive, const int64_t* offset,
                   const float* sky, uint32_t u_hi, uint32_t u_lo,
                   uint32_t v_hi, uint32_t v_lo,
                   void* segments, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Pools p{at, idx_s, inv_a, tri_t, idx_t, shade_pack, tri_pack};
  const MeshHits m{mesh_t, mesh_u, mesh_v, mesh_idx, mesh_hit, pack9, n_tris,
                   mat_row};
  const Lanes s{org, dir, attn, rad, alive, offset, sky, u_hi, u_lo, v_hi,
                v_lo, (unsigned long long*)segments, n};
  const int grid = (n + MB_THREADS - 1) / MB_THREADS;
  mesh_bounce_kernel<<<grid, MB_THREADS, 0, (cudaStream_t)stream>>>(p, m, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
