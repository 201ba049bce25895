"""The plain photon mapper of the cornell-box cell: progressive photon
mapping as the cornell-box command defines it (its bin/main.ml scene and
progressive_photon_map.ml), in plain PyTorch, float64 by default.

It runs the definition of `reference.ppm` (photon budgets, the samples,
the Russian roulette of a diffuse bounce, the radius schedule, the
cone-filter gather, the image), whose gather and radius it calls, over a
scene of sphere and triangle pools with specular materials, and adds:

- Scene (`scene`), from the configuration file alone, in camera space
  (reference.scenes' camera): each quad (a, u, v) is the two triangles
  (a, a + v, a + v + u) and (a, a + v + u, a + u) with texture
  coordinates (0, 0), (1, 0), (1, 1) and (0, 0), (1, 1), (0, 1), of its
  material and colour or checker (squares (w, h) scale the coordinates by
  (w - 1, h - 1)); each sphere of its material, colour and ior.
- Point light. Photon j leaves the light's position p (no offset) along
  (sin phi cos theta, sin phi sin theta, cos phi), theta = 2 pi s0,
  phi = acos(1 - 2 s1), with flux = its colour x power.
- Photon trace. At each of max_bounces bounces a live photon meets the
  nearest sphere or triangle (reference.pt's intersection); a miss ends
  it. A diffuse hit deposits (the point, the normal facing the ray, its
  flux x the albedo) and goes on by Russian roulette as in reference.ppm.
  A metal hit mirrors the photon about the normal with flux x (albedo +
  (1 - albedo)(1 - wi_z)^5) and ends it below the horizon; a dielectric
  reflects it under total internal reflection or where Schlick's
  reflectance exceeds the bounce's first sample u, else refracts it, its
  flux unchanged (reference.pt's scatter). Neither deposits.
- Eye walk. Pixel (x, y)'s primary ray is reference.ppm's. At each of up
  to max_bounces bounces a live lane meets the nearest surface; a miss
  ends it. At its first diffuse hit it records (the point, the facing
  normal, beta x the albedo) and ends; a metal or dielectric hit scatters
  it as a photon's, with the sample of dimension 2 + b at bounce b (the
  eye sampler's D = 2 + max_bounces) and beta x the metal's tint. A lane
  still specular after max_bounces records nothing.
- Radius. init = ((the box's three sides summed) / 3 / ((W + H) / 2))^2,
  the box the camera-space bound of the valid spheres (centre +- radius)
  and triangles, the huge sphere behind the camera included.
- Gather and image: reference.ppm's, over each iteration's recorded hits.

The point light is the only light: the scene's sky is black, and a path
that leaves the scene carries nothing. Departures from reference.ppm's
code, not from the definition: no mesh, and the iterations are traced one
at a time (the eye walk holds W H x triangles pairs at a bounce).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import lds, scenes
from . import ppm as ref_ppm
from .pt import SHADOW, _hit, _scatter, _tensors, _unit

__all__ = ["scene", "box", "render"]

QUAD_UV = [[(0, 0), (1, 0), (1, 1)], [(0, 0), (1, 1), (0, 1)]]


def _quads(config: dict, cam) -> dict:
    """The tri_* arrays of the configuration's quads, two triangles each."""
    a, e1, e2, uv, kind, tex, ca, cb, cwh = ([] for _ in range(9))
    for q in config["quads"]:
        p, u, v = (np.asarray(q[k], np.float64) for k in ("a", "u", "v"))
        for b, c in ((p + v, p + v + u), (p + v + u, p + u)):
            pa, pb, pc = cam.to_camera([p, b, c])
            a.append(pa)
            e1.append(pb - pa)
            e2.append(pc - pa)
        uv.extend(QUAD_UV)
        kind += [scenes.MATERIALS[q["material"]]] * 2
        if "checker" in q:
            tex += [1, 1]
            ca += [q["checker"][0]] * 2
            cb += [q["checker"][1]] * 2
            cwh += [[s - 1.0 for s in q["squares"]]] * 2
        else:
            tex += [0, 0]
            ca += [q["albedo"]] * 2
            cb += [[0.0, 0.0, 0.0]] * 2
            cwh += [[0.0, 0.0]] * 2
    f = lambda x: np.asarray(x, np.float64)
    return dict(tri_a=f(a), tri_e1=f(e1), tri_e2=f(e2), tri_uv=f(uv),
                tri_kind=np.asarray(kind, np.int64),
                tri_tex=np.asarray(tex, np.int64), tri_ca=f(ca),
                tri_cb=f(cb), tri_cwh=f(cwh), tri_ior=np.ones(len(kind)))


def _spheres(config: dict, cam) -> dict:
    """The sph_* arrays of the configuration's spheres (solid colours)."""
    rows = config["spheres"]
    n = len(rows)
    albedo = [s["albedo"] if "albedo" in s else [0.0, 0.0, 0.0]
              for s in rows]
    return dict(sph_c=cam.to_camera([s["center"] for s in rows]),
                sph_r=np.asarray([s["radius"] for s in rows], np.float64),
                sph_kind=np.asarray([scenes.MATERIALS[s["material"]]
                                     for s in rows], np.int64),
                sph_tex=np.zeros(n, np.int64),
                sph_ca=np.asarray(albedo, np.float64),
                sph_cb=np.zeros((n, 3)), sph_cwh=np.zeros((n, 2)),
                sph_ior=np.asarray([s["ior"] if "ior" in s else 1.0
                                    for s in rows], np.float64))


def scene(config: dict, aspect: float):
    """(scene dict, camera, lights) of the configuration for a film of
    aspect `aspect`: its quads and spheres in camera space (scenes'
    layout, no mesh), and its point lights (position in camera space,
    flux = colour x power)."""
    if config["ppm"]["initial_radius"] != "scene_box":
        raise ValueError("the reference's initial radius is the scene box's")
    cam = scenes.camera(config, aspect)
    sc = scenes._empty_scene()
    sc.update(_quads(config, cam))
    sc.update(_spheres(config, cam))
    sc["sky"] = scenes._sky(config)
    lights = []
    for spec in config["lights"]:
        if spec["kind"] != "point":
            raise ValueError(f"the reference's lights are points, not "
                             f"{spec['kind']!r}")
        lights.append(dict(position=cam.to_camera([spec["position"]])[0],
                           flux=np.asarray(spec["color"], np.float64)
                           * spec["power"]))
    return sc, cam, lights


def box(sc: dict) -> tuple[np.ndarray, np.ndarray]:
    """The camera-space (lo, hi) of the valid spheres and triangles."""
    c, r = sc["sph_c"], sc["sph_r"][:, None]
    a = sc["tri_a"]
    pts = np.concatenate([c - r, c + r, a, a + sc["tri_e1"],
                          a + sc["tri_e2"]])
    return pts.min(0), pts.max(0)


def _radius(sc: dict, width: int, height: int, alpha: float, i: int):
    """reference.ppm.radius over the scene's box, which it reads as a mesh
    box: one triangle from lo to hi spans it."""
    lo, hi = box(sc)
    spans = dict(mesh_a=lo[None], mesh_e1=(hi - lo)[None],
                 mesh_e2=np.zeros((1, 3)))
    return ref_ppm.radius(spans, width, height, alpha, i)


def _photons(sc, lights, photon_count, max_bounces, i, device, dtype):
    """The deposits (pos, nrm, flux) of iteration i (from 0) and its photon
    segments."""
    total = sum(float(l["flux"].sum()) for l in lights)
    budgets = [int(photon_count * (float(l["flux"].sum()) / total))
               for l in lights]
    k = torch.repeat_interleave(torch.arange(len(lights), device=device),
                                torch.tensor(budgets, device=device))
    n = k.numel()
    al = lds.alphas(2 + 2 * max_bounces)
    off = (torch.arange(n, device=device) + i * photon_count) % (1 << 32)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    theta = (2.0 * math.pi) * lds.sample(off, al[0]).to(dtype)
    phi = torch.acos(1.0 - 2.0 * lds.sample(off, al[1]).to(dtype))
    d = torch.stack([torch.sin(phi) * torch.cos(theta),
                     torch.sin(phi) * torch.sin(theta), torch.cos(phi)], -1)
    o = t(np.stack([l["position"] for l in lights]))[k]
    flux = t(np.stack([l["flux"] for l in lights]))[k]
    deps, segments = [], 0
    live = torch.arange(n, device=device)
    for b in range(max_bounces):
        segments += live.numel()
        if live.numel() == 0:
            break
        hit, point, nrm, front, kind, alb, ior = _hit(sc, None, o[live],
                                                      d[live], None)
        lh = live[hit]
        point, nrm, front, kind, alb, ior = (x[hit] for x in (
            point, nrm, front, kind, alb, ior))
        u = lds.sample(off[lh], al[2 + 2 * b]).to(dtype)
        v = lds.sample(off[lh], al[3 + 2 * b]).to(dtype)
        diff = kind == 0
        f_dep = flux[lh] * alb
        deps.append((point[diff], nrm[diff], f_dep[diff]))
        # Russian roulette: a diffuse photon goes on where u <= cmax, along
        # the cosine sample of (u / cmax, v), with flux x albedo / cmax
        cmax = alb.amax(-1)
        u_scatter = torch.where(diff, u / torch.where(diff, cmax, 1.0), u)
        dw, mult, ok = _scatter(nrm, d[lh], front, kind, alb, ior,
                                u_scatter, v)
        ok = torch.where(diff, u <= cmax, ok)
        f_new = flux[lh] * mult / torch.where(diff, cmax, 1.0)[:, None]
        live = lh[ok]
        o[live] = point[ok] + SHADOW * dw[ok]
        d[live] = dw[ok]
        flux[live] = f_new[ok]
    return [torch.cat([x[c] for x in deps]) for c in range(3)], segments


def _eye(sc, cam, width, height, max_bounces, i, device, dtype):
    """The eye walk of iteration i: (recorded, point, normal, beta), each
    (W H, .), pixel-major."""
    al = lds.alphas(2 + max_bounces)
    n_pix = width * height
    pix = torch.arange(n_pix, device=device)
    off = (pix + i * n_pix) % (1 << 32)
    cx = ((pix % width).to(torch.float64) + lds.sample(off, al[0])) / width
    cy = ((pix // width).to(torch.float64) + lds.sample(off, al[1])) / height
    d = torch.stack([-cam.half_w + 2.0 * cam.half_w * cx,
                     -cam.half_h + 2.0 * cam.half_h * cy,
                     torch.full_like(cx, -1.0)], -1)
    d = _unit(d).to(dtype)
    o = torch.zeros_like(d)
    beta = torch.ones_like(d)
    fd_pt, fd_nrm, fd_beta = (torch.zeros_like(d) for _ in range(3))
    fd_ok = torch.zeros(n_pix, dtype=torch.bool, device=device)
    live = pix
    for b in range(max_bounces):
        if live.numel() == 0:
            break
        hit, point, nrm, front, kind, alb, ior = _hit(sc, None, o[live],
                                                      d[live], None)
        lh = live[hit]
        point, nrm, front, kind, alb, ior = (x[hit] for x in (
            point, nrm, front, kind, alb, ior))
        diff = kind == 0
        rec = lh[diff]
        fd_pt[rec], fd_nrm[rec] = point[diff], nrm[diff]
        fd_beta[rec] = beta[rec] * alb[diff]
        fd_ok[rec] = True
        u = lds.sample(off[lh], al[2 + b]).to(dtype)
        dw, mult, ok = _scatter(nrm, d[lh], front, kind, alb, ior, u,
                                torch.zeros_like(u))
        ok = ok & ~diff
        live = lh[ok]
        o[live] = point[ok] + SHADOW * dw[ok]
        d[live] = dw[ok]
        beta[live] = beta[live] * mult[ok]
    return fd_ok, fd_pt, fd_nrm, fd_beta


def render(scene: dict, cam, lights: list[dict], width: int, height: int,
           iterations: int, photon_count: int, alpha: float,
           max_bounces: int, device, dtype=torch.float64):
    """The image (H, W, 3) as float64 numpy and the photon segments, int.

    dtype is the precision of every geometric and shading operation (the
    samples and primary directions are made in float64 and rounded to
    it)."""
    if scene["mesh_a"].shape[0]:
        raise ValueError("the reference's specular photon mapper has no mesh")
    if np.asarray(scene["sky"]).any():
        raise ValueError("the reference's photon mapper has no sky light")
    sc = _tensors(scene, device, dtype)
    img = torch.zeros(width * height, 3, dtype=dtype, device=device)
    segments = 0
    for i in range(iterations):
        (q_pos, q_nrm, q_flux), segs = _photons(
            sc, lights, photon_count, max_bounces, i, device, dtype)
        segments += segs
        ok, point, nrm, beta = _eye(sc, cam, width, height, max_bounces, i,
                                    device, dtype)
        r = _radius(scene, width, height, alpha, i + 1)
        flux = ref_ppm.gather(point[ok], nrm[ok], q_pos, q_nrm, q_flux, r)
        scale = math.pi * r * r * ref_ppm.NORMALIZER * photon_count
        img[ok] += beta[ok] * flux / scale
    img = (img / iterations).reshape(height, width, 3).flip(0)
    return img.to(torch.float64).cpu().numpy(), segments
