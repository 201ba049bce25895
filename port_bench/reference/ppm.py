"""The plain photon mapper of the photon-mapped cells: progressive photon
mapping as the ganesha command defines it (its progressive_photon_map.ml:
lights, photon budgets, the photon trace, the eye pass, the radius
schedule, the cone-filter gather), in plain PyTorch, float64 by default.

The image of width W, height H, `iterations` iterations of `photon_count`
photons, `max_bounces` bounces and alpha is defined so:

- Lights. A light's photon budget is int(photon_count x its power / the
  lights' total power), truncated; the lights take consecutive photon
  indices j in their order, and the traced photons are the budgets' sum.
  A spot light at p aimed along a (unit) emits photon j along
  R^T (rho sqrt(s0) cos 2 pi s1, rho sqrt(s0) sin 2 pi s1, 1), where R is
  the shortest-arc rotation taking a to +z (reference.pt's frame) and
  rho = atan(cone / 2) (the reference writes atan, not tan), from
  p + 1e-3 times that direction, with flux = its colour x power.
- Samples (reference.lds). Photon j of iteration i (from 0) draws at the
  offset j + i photon_count (mod 2^32) from D = 2 + 2 max_bounces
  dimensions: (0, 1) its emission, (2 + 2b, 3 + 2b) its bounce b. The eye
  sample of pixel (x, y), y the camera row counted from the image's
  bottom, draws at y W + x + i W H (mod 2^32) from D = 2 + max_bounces:
  (0, 1) jitter it.
- Photon trace. At each of max_bounces bounces a live photon meets the
  nearest surface (reference.pt's intersection: the floor triangles, the
  mesh by reference.bvh's walk); a miss ends it. At a hit it deposits
  (the point, the normal facing the ray, its flux x the albedo). With
  cmax the albedo's largest component and (u, v) the bounce's samples it
  goes on where u <= cmax (Russian roulette), along R^T of the cosine
  direction (sqrt(u') cos 2 pi v, sqrt(u') sin 2 pi v, sqrt(1 - u')),
  u' = u / cmax, R the frame of the hit's normal, from the point plus
  1e-3 times it, with flux x albedo / cmax. The photon segments are the
  live photons summed over the bounces.
- Eye pass. Pixel (x, y)'s ray leaves the camera (the origin) towards
  (-w + 2 w cx, -h + 2 h cy, -1), cx = (x + s0) / W, cy = (y + s1) / H,
  (w, h) the film's half extent, and stops at its first hit (point,
  facing normal, albedo beta).
- Radius. r^2(i) = init (1/i) prod_{0<k<i} (k + alpha) / k for iteration i
  counted from 1, init = ((the mesh box's three sides summed) / 3 /
  ((W + H) / 2))^2, the box the mesh's in camera space.
- Gather. flux(p) = the sum, over the iteration's deposits q with
  |q - p| < r and n_q . n_p > 1e-3, of (1 - |q - p| / r) flux_q (the cone
  filter, k = 1), found through a uniform grid of cell r over the
  deposits, in blocks of hit points. The pixel's share is
  beta flux(p) / (pi r^2 (1 - 2/3)) / photon_count.
- Image. The mean over the iterations, output row Y being camera row
  H - 1 - Y.

The spot lights are the only light: the scene's sky is black, and a path
that leaves the scene carries nothing.

Departure: the cells' scenes are all diffuse, so the eye pass stops at the
first hit and there is no specular walk (nor a specular photon bounce);
render refuses a scene with a metal or dielectric surface, or a sky.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import bvh, lds, scenes
from .pt import SHADOW, _frame, _hit, _tensors, _unit

__all__ = ["lights", "scene", "radius", "gather", "render"]

NDOT_MIN = 1e-3
NORMALIZER = 1.0 - 2.0 / 3.0  # the cone filter's, k = 1
RAY_BATCH = 1 << 22  # eye rays traced at once
GATHER_PAIRS = 1 << 23  # hit x deposit pairs held at once
CELL_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for dz in (-1, 0, 1)]


def _mesh_box(sc: dict) -> tuple[np.ndarray, np.ndarray]:
    a = sc["mesh_a"]
    pts = np.concatenate([a, a + sc["mesh_e1"], a + sc["mesh_e2"]])
    return pts.min(0), pts.max(0)


def lights(config: dict, sc: dict) -> list[dict]:
    """The configuration's spot lights in camera space: position,
    direction (unit), flux (colour x power) and cone (degrees). A light
    `at_box` sits at the mesh box's corner hi + beyond (hi - mid) + offset
    and is aimed at the box centre mid; another at its `position` along
    its `direction`."""
    lo, hi = _mesh_box(sc)
    mid = 0.5 * (lo + hi)
    out = []
    for spec in config["lights"]:
        if spec["kind"] != "spot":
            raise ValueError(f"the reference's lights are spots, not "
                             f"{spec['kind']!r}")
        if "at_box" in spec:
            at = spec["at_box"]
            if at["corner"] != "hi" or spec["aim"] != "box_centre":
                raise ValueError(f"light {spec}: only the hi corner, aimed "
                                 "at the box centre")
            pos = hi + at["beyond"] * (hi - mid) + np.asarray(at["offset"])
            aim = mid - pos
        else:
            pos = np.asarray(spec["position"], np.float64)
            aim = np.asarray(spec["direction"], np.float64)
        out.append(dict(position=pos, direction=aim / np.linalg.norm(aim),
                        flux=np.asarray(spec["color"], np.float64)
                        * spec["power"], cone_deg=float(spec["cone_deg"])))
    return out


def scene(config: dict, vertices, faces, aspect: float):
    """The photon-mapped ganesha: scenes.ganesha_scene's mesh, floor and
    camera, and the configuration's lights. Its `ppm` gathers with the
    radius of the mesh's box (`radius`)."""
    if config["ppm"]["initial_radius"] != "mesh_box":
        raise ValueError("the reference's initial radius is the mesh box's")
    sc, cam = scenes.ganesha_scene(config, vertices, faces, aspect)
    return sc, cam, lights(config, sc)


def radius(sc: dict, width: int, height: int, alpha: float, i: int) -> float:
    """The gather radius of iteration i (from 1)."""
    lo, hi = _mesh_box(sc)
    init = (float((hi - lo).sum()) / 3.0 / ((width + height) / 2.0)) ** 2
    prod = 1.0
    for k in range(1, i):
        prod *= (k + alpha) / k
    return math.sqrt(init * prod / i)


def gather(point, normal, q_pos, q_nrm, q_flux, r: float):
    """The cone-filter flux at hit points `point` (n, 3) with normals
    `normal` from deposits q_* (m, 3): a uniform grid of cell r
    over the deposits (cell keys in float64 from the values as they are),
    each hit against the deposits of its cell and the 26 around it, in
    blocks of at most GATHER_PAIRS pairs; the tests and the sum in the
    inputs' dtype."""
    n, dev = point.shape[0], point.device
    out = torch.zeros_like(point)
    if n == 0 or q_pos.shape[0] == 0:
        return out
    lo = q_pos.to(torch.float64).amin(0)
    cell_of = lambda p: torch.floor((p.to(torch.float64) - lo) / r).long()
    qc = cell_of(q_pos)
    dims = qc.amax(0) + 1
    key_of = lambda c: (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]
    keys, order = torch.sort(key_of(qc))
    q_pos, q_nrm, q_flux = q_pos[order], q_nrm[order], q_flux[order]
    near = cell_of(point)[:, None] + torch.tensor(CELL_OFFSETS, device=dev)
    inside = ((near >= 0) & (near < dims)).all(-1)
    nkey = key_of(near)
    start = torch.searchsorted(keys, nkey)
    count = torch.where(inside, torch.searchsorted(keys, nkey, right=True)
                        - start, 0)
    ends = torch.cumsum(count.sum(1), 0)  # each hit's pairs, cumulated
    r_t = torch.tensor(r, dtype=point.dtype, device=dev)
    h0 = 0
    while h0 < n:
        base = int(ends[h0 - 1]) if h0 else 0
        h1 = max(h0 + 1, int(torch.searchsorted(
            ends, torch.tensor(base + GATHER_PAIRS, device=dev),
            right=True)))
        c = count[h0:h1].reshape(-1)
        s = start[h0:h1].reshape(-1)
        slot = torch.repeat_interleave(torch.arange(c.numel(), device=dev), c)
        first = torch.cumsum(c, 0) - c
        q = torch.arange(slot.numel(), device=dev) - first[slot] + s[slot]
        h = h0 + slot // len(CELL_OFFSETS)
        dv = q_pos[q] - point[h]
        d2 = (dv * dv).sum(-1)
        ok = (d2 < r_t * r_t) & ((q_nrm[q] * normal[h]).sum(-1) > NDOT_MIN)
        w = torch.where(ok, 1.0 - torch.sqrt(d2) / r_t, 0.0)
        out.index_add_(0, h, w[:, None] * q_flux[q])
        h0 = h1
    return out


def _check_scene(scene: dict) -> None:
    kinds = [scene["sph_kind"], scene["tri_kind"]]
    if any((np.asarray(k) != 0).any() for k in kinds):
        raise ValueError("the reference's photon mapper takes all-diffuse "
                         "scenes only: it has no specular walk")
    if np.asarray(scene["sky"]).any():
        raise ValueError("the reference's photon mapper has no sky light")


def _photons(sc, tree, lights, photon_count, max_bounces, its, device, dtype,
             max_walk_steps):
    """The deposits (pos, nrm, flux, iteration) of iterations `its` and
    their photon segments."""
    total = sum(float(l["flux"].sum()) for l in lights)
    budgets = [int(photon_count * (float(l["flux"].sum()) / total))
               for l in lights]
    light = torch.repeat_interleave(torch.arange(len(lights), device=device),
                                    torch.tensor(budgets, device=device))
    n_ph = light.numel()
    al = lds.alphas(2 + 2 * max_bounces)
    it = torch.as_tensor(its, device=device).repeat_interleave(n_ph)
    j = torch.arange(n_ph, device=device).repeat(len(its))
    off = (j + it * photon_count) % (1 << 32)
    s0 = lds.sample(off, al[0]).to(dtype)
    s1 = lds.sample(off, al[1]).to(dtype)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    lights_t = [dict(pos=t(l["position"]), flux=t(l["flux"]),
                     rows=_frame(t(l["direction"])[None]),
                     rho=math.atan(math.radians(l["cone_deg"]) / 2.0))
                for l in lights]
    k = light.repeat(len(its))
    o = torch.zeros(k.numel(), 3, dtype=dtype, device=device)
    d, flux = torch.zeros_like(o), torch.zeros_like(o)
    for i, l in enumerate(lights_t):
        m = k == i
        rr = l["rho"] * torch.sqrt(s0[m])
        th = (2.0 * math.pi) * s1[m]
        lx, ly = rr * torch.cos(th), rr * torch.sin(th)
        r0, r1, r2 = l["rows"]
        d[m] = r0 * lx[:, None] + r1 * ly[:, None] + r2
        o[m] = l["pos"] + SHADOW * d[m]
        flux[m] = l["flux"]
    deps, segments = [], 0
    live = torch.arange(k.numel(), device=device)
    for b in range(max_bounces):
        segments += live.numel()
        if live.numel() == 0:
            break
        hit, point, nrm, _, _, alb, _ = _hit(sc, tree, o[live], d[live],
                                             max_walk_steps)
        lh = live[hit]
        point, nrm, alb = point[hit], nrm[hit], alb[hit]
        f_dep = flux[lh] * alb
        deps.append((point, nrm, f_dep, it[lh]))
        u = lds.sample(off[lh], al[2 + 2 * b]).to(dtype)
        v = lds.sample(off[lh], al[3 + 2 * b]).to(dtype)
        cmax = alb.amax(-1)
        go = u <= cmax
        u2 = u / cmax
        rr = torch.sqrt(u2)
        th = (2.0 * math.pi) * v
        wo = torch.stack([rr * torch.cos(th), rr * torch.sin(th),
                          torch.sqrt(torch.clamp(1.0 - u2, min=0.0))], -1)
        r0, r1, r2 = _frame(nrm)
        dw = r0 * wo[:, 0:1] + r1 * wo[:, 1:2] + r2 * wo[:, 2:3]
        live = lh[go]
        o[live] = point[go] + SHADOW * dw[go]
        d[live] = dw[go]
        flux[live] = f_dep[go] / cmax[go, None]
    cat = lambda x: torch.cat(x) if x else torch.zeros(0, 3, dtype=dtype,
                                                       device=device)
    return ([cat([x[c] for x in deps]) for c in range(3)]
            + [torch.cat([x[3] for x in deps]) if deps
               else torch.zeros(0, dtype=torch.int64, device=device)],
            segments)


def _eye(sc, tree, cam, width, height, max_bounces, its, device, dtype,
         max_walk_steps):
    """The eye hits of iterations `its`, pixel-major per iteration: (hit,
    point, normal, albedo), each (len(its), W H, .)."""
    al = lds.alphas(2 + max_bounces)
    n_pix = width * height
    pix = torch.arange(n_pix, device=device)
    it = torch.as_tensor(its, device=device)
    off = ((pix[None] + it[:, None] * n_pix) % (1 << 32)).reshape(-1)
    px = pix.repeat(len(its))
    cx = ((px % width).to(torch.float64) + lds.sample(off, al[0])) / width
    cy = ((px // width).to(torch.float64) + lds.sample(off, al[1])) / height
    d = torch.stack([-cam.half_w + 2.0 * cam.half_w * cx,
                     -cam.half_h + 2.0 * cam.half_h * cy,
                     torch.full_like(cx, -1.0)], -1)
    d = _unit(d).to(dtype)
    hit, point, nrm, _, _, alb, _ = _hit(sc, tree, torch.zeros_like(d), d,
                                         max_walk_steps)
    shape = (len(its), n_pix)
    return (hit.reshape(shape), point.reshape(shape + (3,)),
            nrm.reshape(shape + (3,)), alb.reshape(shape + (3,)))


def render(scene: dict, cam, lights: list[dict], width: int, height: int,
           iterations: int, photon_count: int, alpha: float,
           max_bounces: int, device, dtype=torch.float64,
           max_walk_steps: int | None = None):
    """The image (H, W, 3) as float64 numpy and the photon segments, int.

    dtype is the precision of every geometric and shading operation (the
    samples and primary directions are made in float64 and rounded to
    it); max_walk_steps bounds the mesh walk (bvh.walk). Iterations are
    traced together, at most RAY_BATCH eye rays at a time."""
    _check_scene(scene)
    sc = _tensors(scene, device, dtype)
    tree = None
    if len(scene["mesh_a"]):
        tree = bvh.MeshTree(scene["mesh_a"], scene["mesh_e1"],
                            scene["mesh_e2"], device, dtype)
        tree.albedo = torch.as_tensor(scene["mesh_albedo"], dtype=dtype,
                                      device=device)
    n_pix = width * height
    img = torch.zeros(n_pix, 3, dtype=dtype, device=device)
    segments = 0
    group = max(1, RAY_BATCH // n_pix)
    for i0 in range(0, iterations, group):
        its = list(range(i0, min(iterations, i0 + group)))
        (q_pos, q_nrm, q_flux, q_it), segs = _photons(
            sc, tree, lights, photon_count, max_bounces, its, device, dtype,
            max_walk_steps)
        segments += segs
        hit, point, nrm, alb = _eye(sc, tree, cam, width, height,
                                    max_bounces, its, device, dtype,
                                    max_walk_steps)
        for g, i in enumerate(its):
            r = radius(scene, width, height, alpha, i + 1)
            mine = q_it == i
            h = hit[g]
            flux = gather(point[g][h], nrm[g][h], q_pos[mine], q_nrm[mine],
                          q_flux[mine], r)
            scale = math.pi * r * r * NORMALIZER * photon_count
            img[h] += alb[g][h] * flux / scale
    img = (img / iterations).reshape(height, width, 3).flip(0)
    return img.to(torch.float64).cpu().numpy(), segments
