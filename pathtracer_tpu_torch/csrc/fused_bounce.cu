// One whole path-tracer bounce per launch, for Hopper (sm_90a).
//
// Replaces: pathtracer_tpu/ops/pallas/fused_bounce_kernel.py:fused_bounce_pallas
// (_kernel_fused and _kernel_fused_listed), which inlines
// sphere_kernel.py:intersect_regs / intersect_regs_listed and
// shade_kernel.py:shade_body. The plain PyTorch version of the same function
// is ops/cuda/fused_bounce_kernel.py:fused_bounce_plain; `shade_lane` below
// mirrors ops/cuda/shade_kernel.py:shade line for line.
//
// Design: one thread per ray over the structure-of-arrays planes
// (state (10, n), radiance (3, n), offsets (n,)). Each CTA copies the (4, S)
// sphere table into shared memory once as float4 [cx, cy, cz, A] (8.6 KB at
// S = 536), so the sphere loop reads one broadcast 16-byte word per sphere.
// The packed material table is read through the read-only cache: only the
// winner's 10 words are fetched. The running minimum (a*t key, index) stays
// in registers. A dead lane copies its state and radiance through and exits;
// a lane that misses adds the background and skips shading. The listed
// variant (bounce 0 in tile-major ray order) walks only the frustum-culled
// sphere list of its 1024-ray block, which is one 32x32 image tile.
//
// Numerics, kept equal to the plain version:
//  - no --use_fast_math: a negative discriminant must make sqrtf NaN so the
//    strict `(at < best) && (at >= 0)` update rejects it (NaN-miss);
//  - -fmad=false: every product and sum rounds on its own, as in eager
//    PyTorch and the Pallas interpreter;
//  - 1.0f / sqrtf(x) where the JAX code has lax.rsqrt (rsqrtf is approximate);
//  - jnp.maximum / jnp.clip propagate NaN, hence jmax / jmin below;
//  - float constants are the float32 values of the JAX code, as hex literals.
//
// Bound on this card: FP32 issue in the sphere loop, ~20 flops per
// ray-sphere pair over S = 536 spheres at bounces >= 1. Left for later PRs:
// FMA contraction (RMSE-gated), a cheaper sqrt-free rejection test, a
// bounding-volume cull of the sphere table, and warp-level regrouping of
// divergent materials.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RAY_BLOCK = 1024;  // rays per tile block (listed variant)
constexpr int THREADS = 256;
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

struct Params {
  const float* sph;  // (4, S)
  int n_spheres;
  const float* pack;  // (10, pack_stride)
  int pack_stride;
  const float* st_in;  // (10, n)
  float* st_out;
  const uint32_t* off;  // (n,)
  const float* rad_in;  // (3, n)
  float* rad_out;
  const int* lists;  // (n / 1024, list_k), listed variant only
  const int* counts;  // (n / 1024,)
  int list_k;
  uint32_t u_hi, u_lo, v_hi, v_lo;
  float bg[6];  // [row 0 rgb, row 1 rgb]
  int n;
};

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
__device__ __forceinline__ void shade_lane(const Params& p, int i, int idx,
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

template <bool LISTED, bool ORIGIN_ZERO, int BG_MODE>
__global__ void __launch_bounds__(THREADS) fused_bounce_kernel(Params p) {
  extern __shared__ float4 sph_s[];
  for (int s = threadIdx.x; s < p.n_spheres; s += THREADS) {
    sph_s[s] = make_float4(p.sph[s], p.sph[p.n_spheres + s],
                           p.sph[2 * p.n_spheres + s],
                           p.sph[3 * p.n_spheres + s]);
  }
  __syncthreads();

  const int n = p.n;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;

  float st[10];
#pragma unroll
  for (int c = 0; c < 10; ++c) st[c] = p.st_in[c * n + i];
  float r_in[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) r_in[c] = p.rad_in[c * n + i];

  if (!(st[9] > 0.0f)) {  // dead lane: pass state and radiance through
#pragma unroll
    for (int c = 0; c < 10; ++c) p.st_out[c * n + i] = st[c];
#pragma unroll
    for (int c = 0; c < 3; ++c) p.rad_out[c * n + i] = r_in[c];
    return;
  }

  const float o0 = st[0], o1 = st[1], o2 = st[2];
  const float d0 = st[3], d1 = st[4], d2 = st[5];
  float od = 0.0f, oq = 0.0f;
  if (!ORIGIN_ZERO) {
    od = o0 * d0 + o1 * d1 + o2 * d2;
    oq = o0 * o0 + o1 * o1 + o2 * o2;
  }
  float best_at = BIG;
  int best_idx = 0;
  auto test = [&](int s) {
    const float4 sp = sph_s[s];
    float bp, g;
    if (ORIGIN_ZERO) {
      bp = sp.x * d0 + sp.y * d1 + sp.z * d2;
      g = sp.w;
    } else {
      bp = sp.x * d0 + sp.y * d1 + sp.z * d2 - od;
      g = sp.w + 2.0f * (sp.x * o0 + sp.y * o1 + sp.z * o2) - oq;
    }
    float disc = g + bp * bp;
    float sq = sqrtf(disc);  // NaN when disc < 0: both compares fail
    bool inside_pos = (g >= 0.0f) && (bp >= 0.0f);
    float at = bp + (inside_pos ? sq : -sq);
    if ((at < best_at) && (at >= 0.0f)) {
      best_at = at;
      best_idx = s;
    }
  };
  if (LISTED) {
    const int blk = i / RAY_BLOCK;
    const int cnt = min(__ldg(p.counts + blk), p.list_k);
    const int* lst = p.lists + (size_t)blk * p.list_k;
    for (int j = 0; j < cnt; ++j) test(__ldg(lst + j));
  } else {
#pragma unroll 8
    for (int s = 0; s < p.n_spheres; ++s) test(s);
  }

  const float a[3] = {st[6], st[7], st[8]};
  if (!(best_at < BIG)) {  // miss: background radiance, lane dies
    float b0, b1, b2;
    if (BG_MODE == 1) {
      float tt = 0.5f * (d1 + 1.0f);
      b0 = p.bg[0] * (1.0f - tt) + p.bg[3] * tt;
      b1 = p.bg[1] * (1.0f - tt) + p.bg[4] * tt;
      b2 = p.bg[2] * (1.0f - tt) + p.bg[5] * tt;
    } else {
      b0 = p.bg[0];
      b1 = p.bg[1];
      b2 = p.bg[2];
    }
    p.rad_out[i] = r_in[0] + a[0] * b0;
    p.rad_out[n + i] = r_in[1] + a[1] * b1;
    p.rad_out[2 * n + i] = r_in[2] + a[2] * b2;
#pragma unroll
    for (int c = 0; c < 9; ++c) p.st_out[c * n + i] = st[c];
    p.st_out[9 * n + i] = 0.0f;
    return;
  }

  const float o[3] = {o0, o1, o2};
  const float d[3] = {d0, d1, d2};
  float out[10];
  shade_lane(p, i, best_idx, o, d, a, out);
#pragma unroll
  for (int c = 0; c < 10; ++c) p.st_out[c * n + i] = out[c];
#pragma unroll
  for (int c = 0; c < 3; ++c) p.rad_out[c * n + i] = r_in[c] + 0.0f;
}

template <bool LISTED, bool ORIGIN_ZERO, int BG_MODE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kern = fused_bounce_kernel<LISTED, ORIGIN_ZERO, BG_MODE>;
  size_t smem = sizeof(float4) * (size_t)p.n_spheres;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  int grid = (p.n + THREADS - 1) / THREADS;
  kern<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// state_in/out (10, n), off (n,), rad_in/out (3, n), all device pointers;
// lists == NULL selects the brute-force variant. Returns the cudaError_t.
int pt_fused_bounce(const float* sph, int n_spheres, const float* pack,
                    int pack_stride, const float* st_in, float* st_out,
                    const uint32_t* off, const float* rad_in, float* rad_out,
                    const int* lists, const int* counts, int list_k,
                    uint32_t u_hi, uint32_t u_lo, uint32_t v_hi, uint32_t v_lo,
                    float bg00, float bg01, float bg02, float bg10, float bg11,
                    float bg12, int n, int bg_mode, int origin_zero,
                    void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  Params p{sph, n_spheres, pack, pack_stride, st_in, st_out, off, rad_in,
           rad_out, lists, counts, list_k, u_hi, u_lo, v_hi, v_lo,
           {bg00, bg01, bg02, bg10, bg11, bg12}, n};
  cudaStream_t s = (cudaStream_t)stream;
  const bool listed = lists != nullptr;
  const int key = (listed ? 4 : 0) | (origin_zero ? 2 : 0) | (bg_mode == 1);
  switch (key) {
    case 0: return (int)launch<false, false, 0>(p, s);
    case 1: return (int)launch<false, false, 1>(p, s);
    case 2: return (int)launch<false, true, 0>(p, s);
    case 3: return (int)launch<false, true, 1>(p, s);
    case 4: return (int)launch<true, false, 0>(p, s);
    case 5: return (int)launch<true, false, 1>(p, s);
    case 6: return (int)launch<true, true, 0>(p, s);
    default: return (int)launch<true, true, 1>(p, s);
  }
}

}  // extern "C"
