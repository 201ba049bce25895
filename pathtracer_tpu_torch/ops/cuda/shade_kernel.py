"""The per-bounce shading stage: the packed material table, the plain
PyTorch version of the in-kernel shading, and the shading half of the
two-kernel bounce.

Port of pathtracer_tpu/ops/pallas/shade_kernel.py (pack_material_tables,
shade_body and its helpers _atan_poly, _atan2, _acos, _lds, shade_pallas).
On the card this math runs in csrc/pt_bounce.cuh, which mirrors `shade`
below line for line, inside the fused bounce kernel (csrc/fused_bounce.cu)
and the shade kernel (csrc/shade.cu, launched by `shade_state`); the
functions here are their plain version, used for CPU tensors and as the
yardstick on the card. Square roots go through ops/vec.sqrt, which is
correctly rounded on the CPU too, as CUDA's sqrtf is.

The polynomial atan2/acos are kept as written (Mosaic had no acos/atan
lowering) so the port matches the JAX kernel closely; so is the u15/u16
albedo packing. Every constant is the float32 value the JAX code uses, and
`jnp.maximum`/`jnp.clip` become NaN-propagating torch.clamp.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _build
from .. import vec
from ..lds import M32, hi_word
from . import check_tensors
from .sphere_kernel import BIG, LANES, check_state

_f32 = lambda x: float(np.float32(x))
_PI = _f32(np.pi)
_HALF_PI = _f32(0.5 * np.pi)
_TWO_PI = _f32(2.0 * np.pi)
_TWO_PI_INV = _f32(0.5 / np.pi)
_PI_INV = _f32(1.0 / np.pi)
_ATAN_P0 = _f32(-0.0016994898)
_ATAN_C = tuple(_f32(c) for c in (0.010494779, -0.030393856, 0.057162132,
                                  -0.083558545, 0.10935136, -0.14260697,
                                  0.19998156, -0.3333328, 1.0))
_EPS = np.float32(1e-6)
_POLE_TOP = float(np.float32(1.0) - _EPS)
_POLE_BOT = float(_EPS - np.float32(1.0))
_SHADOW = _f32(1e-3)
_LDS_SCALE = _f32(2.0 ** -31)
_ONE_MINUS_EPS = _f32(1.0 - 2.0 ** -24)

PK_PLANES = 10  # 7 f32 geometry + 3 bit-packed (u32 bit patterns in f32)
_Q15 = 32767.0
_Q16 = 65535.0
_C15 = _f32(1.0 / _Q15)
_C16 = _f32(1.0 / _Q16)


def _atan_poly(z):
    """Minimax atan on |z| <= 1 (f32 Horner), as the JAX kernel's."""
    t = z * z
    p = torch.full_like(z, _ATAN_P0)
    for c in _ATAN_C:
        p = p * t + c
    return z * p


def _atan2(y, x):
    """Full-quadrant atan2 from the atan polynomial."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.where(swap, ay, ax)
    r = _atan_poly(num / torch.clamp(den, min=_f32(1e-30)))
    r = torch.where(swap, _HALF_PI - r, r)
    r = torch.where(x < 0.0, _PI - r, r)
    return torch.where(y < 0.0, -r, r)


def _acos(x):
    """acos via atan2(sqrt((1-x)(1+x)), x)."""
    s = vec.sqrt(torch.clamp((1.0 - x) * (1.0 + x), min=0.0))
    return _atan2(s, x)


def _lds(off, hi: int, lo: int):
    """The in-kernel fixed-point LDS draw: f32(int32(v >> 1)) * 2^-31 (the
    JAX kernel drops the lowest bit because Mosaic cannot cast uint32 to
    f32). ops/lds.sample_fixed is the other conversion, f32(v) * 2^-32.
    off: integer tensor of uint32 bit patterns."""
    m = (off.to(torch.int64) + 1) & M32
    v = hi_word(hi, lo, m)
    s = (v >> 1).to(torch.float32) * _LDS_SCALE
    return torch.clamp(s, max=_ONE_MINUS_EPS)


def pack_material_tables(shade_pack: torch.Tensor) -> torch.Tensor:
    """(S, 16) f32 shade_pack -> (10, Sq, 128) f32 packed table,
    Sq = ceil(S/128), entry s at [:, s // 128, s % 128].

    Planes 0-6: cx, cy, cz, radius, ior, checker_w, checker_h (f32).
    Planes 7-9: uint32 bit patterns held in f32:
          u0 = ca0_u15 | ca1_u15<<15 | mat_k<<30
          u1 = ca2_u15 | cb0_u15<<15 | tex_k<<30
          u2 = cb1_u16 | cb2_u16<<16
    with albedos clamped to [0, 1] and rounded half to even."""
    pk = shade_pack

    def q(col, scale):
        return torch.round(torch.clamp(pk[:, col], 0.0, 1.0) * scale).to(
            torch.int64)

    def bits(u):  # uint32 value in int64 -> the same bits as f32
        return (u & M32).to(torch.int32).view(torch.float32)

    kind = lambda col: pk[:, col].to(torch.int64)
    u0 = q(6, _Q15) | (q(7, _Q15) << 15) | (kind(4) << 30)
    u1 = q(8, _Q15) | (q(9, _Q15) << 15) | (kind(5) << 30)
    u2 = q(10, _Q16) | (q(11, _Q16) << 16)
    tab = torch.stack([pk[:, 0], pk[:, 1], pk[:, 2], pk[:, 3], pk[:, 14],
                       pk[:, 12], pk[:, 13], bits(u0), bits(u1), bits(u2)])
    pad = (-tab.shape[1]) % 128
    tab = torch.nn.functional.pad(tab, (0, pad))
    return tab.reshape(PK_PLANES, -1, 128).contiguous()


def _rot(qw, qx, qy, v0, v1, v2, inv: bool):
    """Rotate v by the quaternion (qw, qx, qy, 0); inv negates the vector
    part."""
    rx, ry = (-qx, -qy) if inv else (qx, qy)
    t0 = 2.0 * (ry * v2)
    t1 = 2.0 * (-rx * v2)
    t2 = 2.0 * (rx * v1 - ry * v0)
    w0 = v0 + qw * t0 + (ry * t2)
    w1 = v1 + qw * t1 + (-rx * t2)
    w2 = v2 + qw * t2 + (rx * t1 - ry * t0)
    return w0, w1, w2


def shade(pack_table, state, off, idx, hit, limbs, bg, rad_in, bg_mode: int):
    """Plain version of the shading stage for one bounce (JAX shade_body).

    pack_table (10, Sq, 128) f32; state (10, ...) f32 [org3, dir3, attn3,
    alive]; off (...) int32 LDS offsets (uint32 bit patterns); idx (...)
    winner sphere index; hit (...) bool (winner found and lane alive);
    limbs (2, 2) uint32 [[u_hi, u_lo], [v_hi, v_lo]]; bg ((r, g, b),
    (r, g, b)) floats; rad_in (3, ...) f32 radiance accumulator.
    Returns (new_state, rad) as new tensors."""
    o0, o1, o2 = state[0], state[1], state[2]
    d0, d1, d2 = state[3], state[4], state[5]
    a0, a1, a2 = state[6], state[7], state[8]
    alive = state[9] > 0.0
    a_q = d0 * d0 + d1 * d1 + d2 * d2
    inv_a = 1.0 / a_q

    flat = pack_table.reshape(PK_PLANES, -1)
    pk = flat[:, idx.to(torch.int64)]
    cx, cy, cz, rad_s = pk[0], pk[1], pk[2], pk[3]
    ior, cw, ch = pk[4], pk[5], pk[6]
    ior_inv = 1.0 / torch.clamp(ior, min=_f32(1e-30))
    u0, u1, u2 = (pk[p].view(torch.int32).to(torch.int64) & M32
                  for p in (7, 8, 9))

    def f15(u):
        return (u & 0x7FFF).to(torch.float32) * _C15

    ca0, ca1 = f15(u0), f15(u0 >> 15)
    ca2, cb0 = f15(u1), f15(u1 >> 15)
    cb1 = (u2 & 0xFFFF).to(torch.float32) * _C16
    cb2 = (u2 >> 16).to(torch.float32) * _C16
    mat_u = u0 >> 30
    tex_u = u1 >> 30

    # stable t from the winner's params
    f0, f1, f2 = cx - o0, cy - o1, cz - o2
    bp = f0 * d0 + f1 * d1 + f2 * d2
    quad_f = f0 * f0 + f1 * f1 + f2 * f2
    r2 = rad_s * rad_s
    c_c = quad_f - r2
    disc = r2 - quad_f + bp * bp * inv_a
    sgn = torch.where(bp >= 0.0, 1.0, -1.0)
    qq = sgn * vec.sqrt(torch.clamp(a_q * disc, min=0.0)) + bp
    t = torch.where(c_c > 0.0, c_c / qq, qq * inv_a)

    # hit point + flipped normal
    p0, p1, p2 = o0 + t * d0, o1 + t * d1, o2 + t * d2
    n0, n1, n2 = p0 - cx, p1 - cy, p2 - cz
    ninv = 1.0 / vec.sqrt(torch.clamp(n0 * n0 + n1 * n1 + n2 * n2,
                                        min=_f32(1e-38)))
    n0, n1, n2 = n0 * ninv, n1 * ninv, n2 * ninv
    ddn = d0 * n0 + d1 * n1 + d2 * n2
    front = ddn < 0.0
    fs = torch.where(front, 1.0, -1.0)
    n0, n1, n2 = n0 * fs, n1 * fs, n2 * fs

    # spherical uv, checker parity
    theta = _acos(torch.clamp(-n1, -1.0, 1.0))
    phi = _PI + _atan2(-n2, n0)
    u_t = phi * _TWO_PI_INV
    v_t = theta * _PI_INV
    pxp = torch.trunc(u_t * cw).to(torch.int32) & 1
    pyp = torch.trunc(v_t * ch).to(torch.int32) & 1
    odd = (tex_u == 1) & (pxp != pyp)
    alb0 = torch.where(odd, cb0, ca0)
    alb1 = torch.where(odd, cb1, ca1)
    alb2 = torch.where(odd, cb2, ca2)

    # tangent frame quaternion
    gw = 1.0 + n2
    gnorm = 1.0 / vec.sqrt(torch.clamp(gw * gw + n1 * n1 + n0 * n0,
                                         min=_f32(1e-38)))
    qw = gw * gnorm
    qx = n1 * gnorm
    qy = -n0 * gnorm
    top = n2 > _POLE_TOP
    bot = n2 < _POLE_BOT
    qw = torch.where(top, 1.0, torch.where(bot, 0.0, qw))
    qx = torch.where(top | bot, 0.0, qx)
    qy = torch.where(top, 0.0, torch.where(bot, 1.0, qy))

    wi0, wi1, wi2 = _rot(qw, qx, qy, -d0, -d1, -d2, False)

    limbs = np.asarray(limbs, np.uint32)
    u = _lds(off, int(limbs[0, 0]), int(limbs[0, 1]))
    v = _lds(off, int(limbs[1, 0]), int(limbs[1, 1]))

    # scatter: lambertian cosine hemisphere
    rr = vec.sqrt(u)
    th = v * _TWO_PI
    lam0 = rr * torch.cos(th)
    lam1 = rr * torch.sin(th)
    lam2 = vec.sqrt(torch.clamp(1.0 - u, min=0.0))
    lam_ok = lam2 > 0.0
    # metal: mirror + Schlick tint
    met0, met1, met2 = -wi0, -wi1, wi2
    met_ok = met2 > 0.0
    s5 = 1.0 - wi2
    s5 = s5 * s5 * s5 * s5 * s5
    tn0 = alb0 + (1.0 - alb0) * s5
    tn1 = alb1 + (1.0 - alb1) * s5
    tn2 = alb2 + (1.0 - alb2) * s5
    # dielectric
    ci = torch.clamp(wi2, 0.0, 1.0)
    si = vec.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    ratio = torch.where(front, ior_inv, ior)
    r0s = (1.0 - ratio) / (1.0 + ratio)
    r0s = r0s * r0s
    omc = 1.0 - ci
    omc5 = omc * omc * omc * omc * omc
    schl = r0s + (1.0 - r0s) * omc5
    do_refl = (ratio * si > 1.0) | (schl > u)
    cc = torch.clamp(wi2, max=1.0)
    pe0 = ratio * (-wi0)
    pe1 = ratio * (-wi1)
    pe2 = ratio * (cc - wi2)
    para = -vec.sqrt(torch.abs(1.0 - (pe0 * pe0 + pe1 * pe1 + pe2 * pe2)))
    die0 = torch.where(do_refl, met0, pe0)
    die1 = torch.where(do_refl, met1, pe1)
    die2 = torch.where(do_refl, met2, pe2 + para)

    is_met = mat_u == 1
    is_die = mat_u == 2
    wo0 = torch.where(is_die, die0, torch.where(is_met, met0, lam0))
    wo1 = torch.where(is_die, die1, torch.where(is_met, met1, lam1))
    wo2 = torch.where(is_die, die2, torch.where(is_met, met2, lam2))
    am0 = torch.where(is_die, 1.0, torch.where(is_met, tn0, alb0))
    am1 = torch.where(is_die, 1.0, torch.where(is_met, tn1, alb1))
    am2 = torch.where(is_die, 1.0, torch.where(is_met, tn2, alb2))
    ok = is_die | (is_met & met_ok) | (~is_die & ~is_met & lam_ok)

    # world ray with the shadow-acne offset
    dw0, dw1, dw2 = _rot(qw, qx, qy, wo0, wo1, wo2, True)
    no0 = p0 + _SHADOW * dw0
    no1 = p1 + _SHADOW * dw1
    no2 = p2 + _SHADOW * dw2

    # miss: background radiance, rad += attn * bg
    miss = alive & ~hit
    (w0, w1, w2), (s0, s1, s2) = bg
    if bg_mode == 1:
        tt = 0.5 * (d1 + 1.0)
        b0 = _f32(w0) * (1.0 - tt) + _f32(s0) * tt
        b1 = _f32(w1) * (1.0 - tt) + _f32(s1) * tt
        b2 = _f32(w2) * (1.0 - tt) + _f32(s2) * tt
    else:
        b0, b1, b2 = (torch.full_like(d0, _f32(c)) for c in (w0, w1, w2))
    rad = torch.stack([rad_in[0] + torch.where(miss, a0 * b0, 0.0),
                       rad_in[1] + torch.where(miss, a1 * b1, 0.0),
                       rad_in[2] + torch.where(miss, a2 * b2, 0.0)])

    new_alive = hit & ok
    sel = lambda new, old: torch.where(new_alive, new, old)
    out = torch.stack([sel(no0, o0), sel(no1, o1), sel(no2, o2),
                       sel(dw0, d0), sel(dw1, d1), sel(dw2, d2),
                       sel(a0 * am0, a0), sel(a1 * am1, a1),
                       sel(a2 * am2, a2), new_alive.to(torch.float32)])
    return out, rad


def shade_state_plain(state, pack_table, idx, off, at, limbs, bg, rad, *,
                      bg_mode: int):
    """Plain PyTorch version of shade_state: `shade` with hit = at < BIG
    on a live lane."""
    hit = (at < BIG) & (state[9] > 0.0)
    return shade(pack_table, state, off, idx, hit, limbs, bg, rad, bg_mode)


def shade_state(state, pack_table, idx, off, at, limbs, bg, rad, *,
                bg_mode: int):
    """The shading of one bounce from a given intersection (the JAX
    shade_pallas): state (10, rows, 128) f32; pack_table (10, Sq, 128) f32;
    idx (rows, 128) int32 and at (rows, 128) f32 from
    sphere_kernel.intersect_state (idx must index pack_table); off
    (rows, 128) int32 LDS offsets; limbs (2, 2) uint32; bg the two
    background rows; rad (3, rows, 128) f32 radiance accumulator. A live
    lane with at < BIG is shaded, a live lane that missed gains the
    background and dies, a dead lane passes through. Returns new
    (state, rad) tensors (the JAX kernel updates them in place).

    CPU tensors run shade_state_plain; CUDA tensors launch csrc/shade.cu
    (counted in `shade_state.launches`); anything else raises."""
    if state.device.type == "cpu":
        return shade_state_plain(state, pack_table, idx, off, at, limbs, bg,
                                 rad, bg_mode=bg_mode)
    rows = check_state("shade_state", state)
    check_tensors("shade_state", state.device, [
        ("state", state, torch.float32, (10, rows, LANES)),
        ("pack_table", pack_table, torch.float32,
         (PK_PLANES, pack_table.shape[1], LANES)),
        ("idx", idx, torch.int32, (rows, LANES)),
        ("off", off, torch.int32, (rows, LANES)),
        ("at", at, torch.float32, (rows, LANES)),
        ("rad", rad, torch.float32, (3, rows, LANES))])
    limbs = np.asarray(limbs, np.uint32)
    (w0, w1, w2), (s0, s1, s2) = bg
    lib = _build.load()
    state_out = torch.empty_like(state)
    rad_out = torch.empty_like(rad)
    err = lib.pt_shade_state(
        pack_table.data_ptr(), pack_table.shape[1] * LANES, state.data_ptr(),
        state_out.data_ptr(), idx.data_ptr(), off.data_ptr(), at.data_ptr(),
        rad.data_ptr(), rad_out.data_ptr(), int(limbs[0, 0]),
        int(limbs[0, 1]), int(limbs[1, 0]), int(limbs[1, 1]), w0, w1, w2, s0,
        s1, s2, rows * LANES, int(bg_mode),
        torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(lib, err, "shade_state")
    shade_state.launches += 1
    return state_out, rad_out


shade_state.launches = 0
