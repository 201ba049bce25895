"""The plain path tracer of the path-traced cells.

The image of width W, height H, `spp` samples a pixel and `bounces`
bounces is defined so:

- Sample j of pixel (x, y) has the offset n = y W + x + j spp and draws
  from the sampler (`lds`) with D = 2 + 2 bounces dimensions: (0, 1)
  jitter the pixel, (2 + 2b, 3 + 2b) drive bounce b. Its primary ray
  leaves the camera (the origin) towards (-w + 2w cx, -h + 2h cy, -1),
  normalised, with cx = (x + dx) / W and cy = 1 - (y + dy) / H, where
  (w, h) is the film's half extent.
- At each bounce a live path meets the nearest sphere, floor triangle or
  mesh triangle at t >= 0 (a sphere wins a tie with a triangle; the mesh
  wins only where strictly nearer; a sphere's t is the source's stable
  root, `_spheres`). A miss adds attenuation x sky(d) and
  ends the path, the sky being lerp(0.5 (d_y + 1), white, (0.5, 0.7, 1)).
- A hit's normal faces the ray. Its tangent frame is the shortest-arc
  rotation R taking the normal to +z (the identity within 1e-6 of +z, the
  half turn about y within 1e-6 of -z). With wi = R(-d) and the bounce's
  samples (u, v): a lambertian scatters to (sqrt(u) cos 2 pi v,
  sqrt(u) sin 2 pi v, sqrt(1 - u)) and multiplies by its albedo; a metal
  mirrors wi, multiplies by albedo + (1 - albedo)(1 - wi_z)^5 and ends the
  path below the horizon; a dielectric reflects under total internal
  reflection or where Schlick's reflectance exceeds u, else refracts, at
  attenuation 1. The new ray starts 1e-3 along its direction R^T wo from
  the hit point (on a sphere o + t d, on a triangle a + u e1 + v e2).
- A sphere's albedo comes from its texture at (phi / 2 pi, theta / pi) of
  the normal, theta = acos(-n_y), phi = pi + atan2(-n_z, n_x); a
  triangle's at its interpolated texture coordinates. A checker picks the
  first colour where trunc(u cw) and trunc(v ch) have equal parity.
- A path lives at most `bounces` bounces. The segments are the live paths
  summed over the bounces; the film is `film.develop`.

All samples of a batch of passes are traced together, live paths only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import bvh, film, lds
from .scenes import Camera

__all__ = ["render"]

SHADOW = 1e-3
POLE = 1e-6
SPHERE_CHUNK = 1 << 23  # ray x sphere pairs held at once


def _tensors(scene: dict, device, dtype) -> dict:
    out = {}
    for k, v in scene.items():
        if k.startswith("mesh_"):
            continue
        is_int = np.asarray(v).dtype.kind in "iu"
        out[k] = torch.as_tensor(v, dtype=torch.int64 if is_int else dtype,
                                 device=device)
    return out


def _dot(a, b):
    return (a * b).sum(-1)


def _unit(a):
    return a / torch.sqrt(_dot(a, a))[..., None]


def _spheres(sc, o, d):
    """Nearest sphere hit at t >= 0: (t, index); a miss is (inf, 0).

    A sphere's t is the source's stable quadratic (sphere.ml of the
    reference renderer): with b = (c - o).d, c' = |c - o|^2 - r^2 and
    q = b + sign(b) sqrt(b^2 - |d|^2 c'), t = c'/q outside the sphere
    (c' > 0) and q/|d|^2 inside it. Inside, a ray moving away from the
    centre (b < 0) so gets a negative t and misses the sphere."""
    n = o.shape[0]
    s = sc["sph_r"].shape[0]
    t_best = torch.full((n,), math.inf, dtype=o.dtype, device=o.device)
    i_best = torch.zeros(n, dtype=torch.int64, device=o.device)
    if s == 0:
        return t_best, i_best
    step = max(1, SPHERE_CHUNK // s)
    r2 = sc["sph_r"] ** 2
    for lo in range(0, n, step):
        oc = sc["sph_c"][None] - o[lo:lo + step, None]  # (m, S, 3)
        dd = d[lo:lo + step, None]
        a = _dot(dd, dd)
        b = _dot(oc, dd)
        c = _dot(oc, oc) - r2
        disc = b * b - a * c
        root = torch.sqrt(torch.clamp(disc, min=0.0))
        q = b + torch.where(b >= 0, root, -root)
        t = torch.where(c > 0, c / q, q / a)
        t = torch.where((disc >= 0) & (t >= 0), t, math.inf)
        t_best[lo:lo + step], i_best[lo:lo + step] = t.min(1)
    return t_best, i_best


def _pool_tris(sc, o, d):
    """Nearest floor-pool triangle: (t, index, u, v); a miss is t = inf."""
    n = o.shape[0]
    if sc["tri_a"].shape[0] == 0:
        z = torch.zeros(n, dtype=o.dtype, device=o.device)
        return (torch.full_like(z, math.inf),
                torch.zeros(n, dtype=torch.int64, device=o.device), z, z)
    ok, t, u, v = bvh.mt_test(o[:, None], d[:, None], sc["tri_a"][None],
                              sc["tri_e1"][None], sc["tri_e2"][None])
    t = torch.where(ok, t, math.inf)
    t_min, j = t.min(1)
    pick = lambda x: x.gather(1, j[:, None])[:, 0]
    return t_min, j, pick(u), pick(v)


def _frame(n):
    """The rows of R, the shortest-arc rotation taking unit n to +z, with
    the pole cases. Returns (r0, r1, r2), each (..., 3)."""
    nx, ny, nz = n.unbind(-1)
    f = 1.0 / (1.0 + nz)
    one, zero = torch.ones_like(nx), torch.zeros_like(nx)
    r0 = torch.stack([1.0 - nx * nx * f, -nx * ny * f, -nx], -1)
    r1 = torch.stack([-nx * ny * f, 1.0 - ny * ny * f, -ny], -1)
    r2 = torch.stack([nx, ny, nz], -1)
    top = (nz > 1.0 - POLE)[..., None]
    bot = (nz < -(1.0 - POLE))[..., None]
    ex = torch.stack([one, zero, zero], -1)
    ey = torch.stack([zero, one, zero], -1)
    ez = torch.stack([zero, zero, one], -1)
    r0 = torch.where(top, ex, torch.where(bot, -ex, r0))
    r1 = torch.where(top | bot, ey, r1)
    r2 = torch.where(top, ez, torch.where(bot, -ez, r2))
    return r0, r1, r2


def _albedo(tex, ca, cb, cwh, u, v):
    px = torch.trunc(u * cwh[:, 0]).to(torch.int64) & 1
    py = torch.trunc(v * cwh[:, 1]).to(torch.int64) & 1
    checker = torch.where((px == py)[:, None], ca, cb)
    return torch.where((tex == 1)[:, None], checker, ca)


def _hit(sc, tree, o, d, max_walk_steps):
    """The nearest hit of rays o, d: (hit, point, facing normal, front,
    kind, albedo, ior) per ray."""
    t_s, i_s = _spheres(sc, o, d)
    t_t, i_t, u_t, v_t = _pool_tris(sc, o, d)
    use_tri = t_t < t_s
    t_cur = torch.where(use_tri, t_t, t_s)
    if tree is not None:
        hit_m, t_m, u_m, v_m, id_m = bvh.walk(tree, o, d, t_cur,
                                              max_walk_steps)
        id_m = torch.where(hit_m, id_m, 0)
    else:
        hit_m = torch.zeros_like(use_tri)
    use_sph = ~use_tri & ~hit_m & torch.isfinite(t_s)
    use_tri = use_tri & ~hit_m
    hit = use_sph | use_tri | hit_m

    if sc["sph_r"].shape[0]:
        p_s = o + t_s[:, None] * d
        n_s = _unit(p_s - sc["sph_c"][i_s])
    else:
        p_s = n_s = torch.zeros_like(o)
    a, e1, e2 = sc["tri_a"], sc["tri_e1"], sc["tri_e2"]
    if a.shape[0]:
        p_t = a[i_t] + u_t[:, None] * e1[i_t] + v_t[:, None] * e2[i_t]
        n_t = _unit(bvh.cross(e1[i_t], e2[i_t]))
    else:
        p_t, n_t = p_s, n_s
    point = torch.where(use_tri[:, None], p_t, p_s)
    n_g = torch.where(use_tri[:, None], n_t, n_s)
    if tree is not None:
        me1, me2 = tree.e1[id_m], tree.e2[id_m]
        p_m = tree.a[id_m] + u_m[:, None] * me1 + v_m[:, None] * me2
        point = torch.where(hit_m[:, None], p_m, point)
        n_g = torch.where(hit_m[:, None], _unit(bvh.cross(me1, me2)), n_g)
    front = _dot(d, n_g) < 0
    n = torch.where(front[:, None], n_g, -n_g)

    # texture coordinates: a sphere's from its facing normal, a floor
    # triangle's interpolated
    theta = torch.acos(torch.clamp(-n[:, 1], -1.0, 1.0))
    phi = math.pi + torch.atan2(-n[:, 2], n[:, 0])
    tu, tv = phi / (2.0 * math.pi), theta / math.pi
    alb = _albedo(sc["sph_tex"][i_s], sc["sph_ca"][i_s], sc["sph_cb"][i_s],
                  sc["sph_cwh"][i_s], tu, tv) if sc["sph_r"].shape[0] \
        else torch.zeros_like(o)
    kind = sc["sph_kind"][i_s] if sc["sph_r"].shape[0] \
        else torch.zeros_like(i_s)
    ior = sc["sph_ior"][i_s] if sc["sph_r"].shape[0] \
        else torch.ones_like(t_s)
    if a.shape[0]:
        uv = sc["tri_uv"][i_t]  # (n, 3, 2)
        w = 1.0 - u_t - v_t
        tri_uv = uv[:, 0] * w[:, None] + uv[:, 1] * u_t[:, None] \
            + uv[:, 2] * v_t[:, None]
        alb_t = _albedo(sc["tri_tex"][i_t], sc["tri_ca"][i_t],
                        sc["tri_cb"][i_t], sc["tri_cwh"][i_t], tri_uv[:, 0],
                        tri_uv[:, 1])
        alb = torch.where(use_tri[:, None], alb_t, alb)
        kind = torch.where(use_tri, sc["tri_kind"][i_t], kind)
        ior = torch.where(use_tri, sc["tri_ior"][i_t], ior)
    if tree is not None:
        alb = torch.where(hit_m[:, None], tree.albedo, alb)
        kind = torch.where(hit_m, 0, kind)
    return hit, point, n, front, kind, alb, ior


def _scatter(n, d, front, kind, alb, ior, u, v):
    """The world direction, attenuation and survival of each hit."""
    r0, r1, r2 = _frame(n)
    md = -d
    wi = torch.stack([_dot(r0, md), _dot(r1, md), _dot(r2, md)], -1)
    wx, wy, wz = wi.unbind(-1)
    # lambertian
    rr = torch.sqrt(u)
    th = (2.0 * math.pi) * v
    lam = torch.stack([rr * torch.cos(th), rr * torch.sin(th),
                       torch.sqrt(torch.clamp(1.0 - u, min=0.0))], -1)
    # metal
    met = torch.stack([-wx, -wy, wz], -1)
    tint = alb + (1.0 - alb) * ((1.0 - wz) ** 5)[:, None]
    # dielectric
    ci = torch.clamp(wz, 0.0, 1.0)
    si = torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    ratio = torch.where(front, 1.0 / ior, ior)
    r0s = ((1.0 - ratio) / (1.0 + ratio)) ** 2
    schlick = r0s + (1.0 - r0s) * (1.0 - ci) ** 5
    refl = (ratio * si > 1.0) | (schlick > u)
    perp = ratio[:, None] * torch.stack(
        [-wx, -wy, torch.clamp(wz, max=1.0) - wz], -1)
    para = -torch.sqrt(torch.abs(1.0 - _dot(perp, perp)))
    refr = perp + torch.stack([torch.zeros_like(para), torch.zeros_like(para),
                               para], -1)
    die = torch.where(refl[:, None], met, refr)

    is_met, is_die = kind == 1, kind == 2
    wo = torch.where(is_die[:, None], die,
                     torch.where(is_met[:, None], met, lam))
    attn = torch.where(is_die[:, None], torch.ones_like(alb),
                       torch.where(is_met[:, None], tint, alb))
    ok = is_die | (is_met & (wz > 0)) | (~is_met & ~is_die & (lam[:, 2] > 0))
    # world direction R^T wo
    dw = r0 * wo[:, 0:1] + r1 * wo[:, 1:2] + r2 * wo[:, 2:3]
    return dw, attn, ok


def render(scene: dict, cam: Camera, width: int, height: int, spp: int,
           bounces: int, device, dtype=torch.float64,
           max_walk_steps: int | None = None, ray_batch: int = 1 << 22):
    """The image (H, W, 3) as float64 numpy and the segments, int.

    dtype is the precision of every geometric and shading operation (the
    samples and primary directions are made in float64 and rounded to it);
    max_walk_steps bounds the mesh walk (bvh.walk)."""
    sc = _tensors(scene, device, dtype)
    tree = None
    if len(scene["mesh_a"]):
        tree = bvh.MeshTree(scene["mesh_a"], scene["mesh_e1"],
                            scene["mesh_e2"], device, dtype)
        tree.albedo = torch.as_tensor(scene["mesh_albedo"], dtype=dtype,
                                      device=device)
    al = lds.alphas(2 + 2 * bounces)
    n_pix = width * height
    pix = torch.arange(n_pix, device=device)
    sums = torch.zeros(n_pix, 3, dtype=dtype, device=device)
    sky_lo, sky_hi = sc["sky"][0], sc["sky"][1]
    segments = 0
    group = max(1, ray_batch // n_pix)
    for p0 in range(0, spp, group):
        passes = torch.arange(p0, min(spp, p0 + group), device=device)
        off = (pix[None] + passes[:, None] * spp).reshape(-1)
        px = pix.repeat(passes.numel())
        cx = ((px % width).to(torch.float64) + lds.sample(off, al[0])) / width
        cy = 1.0 - ((px // width).to(torch.float64)
                    + lds.sample(off, al[1])) / height
        d = torch.stack([-cam.half_w + 2.0 * cam.half_w * cx,
                         -cam.half_h + 2.0 * cam.half_h * cy,
                         torch.full_like(cx, -1.0)], -1)
        d = _unit(d).to(dtype)
        o = torch.zeros_like(d)
        attn = torch.ones_like(d)
        rad = torch.zeros_like(d)
        live = torch.arange(off.numel(), device=device)
        for b in range(bounces):
            segments += live.numel()
            if live.numel() == 0:
                break
            ol, dl = o[live], d[live]
            hit, point, n, front, kind, alb, ior = _hit(sc, tree, ol, dl,
                                                        max_walk_steps)
            miss = live[~hit]
            t = 0.5 * (d[miss, 1:2] + 1.0)
            rad[miss] += attn[miss] * ((1.0 - t) * sky_lo + t * sky_hi)
            lh = live[hit]
            u = lds.sample(off[lh], al[2 + 2 * b]).to(dtype)
            v = lds.sample(off[lh], al[3 + 2 * b]).to(dtype)
            dw, mult, ok = _scatter(n[hit], dl[hit], front[hit], kind[hit],
                                    alb[hit], ior[hit], u, v)
            live = lh[ok]
            o[live] = point[hit][ok] + SHADOW * dw[ok]
            d[live] = dw[ok]
            attn[live] = attn[live] * mult[ok]
        sums.index_add_(0, px, rad)
    img = film.develop(sums.reshape(height, width, 3), spp)
    return img.to(torch.float64).cpu().numpy(), segments
