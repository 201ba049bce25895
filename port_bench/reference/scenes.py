"""The scenes of the path-traced cells, worked out in float64 on the host
from their configuration files (`configs/<config>.json`): the camera, the
sky, the shirley sphere list of a seed, and the ganesha mesh with its
material and floor.

Everything is expressed in camera space (the camera at the origin looking
down -z), where the cells' shading is defined: the sky's gradient follows
a direction's camera-space y, a sphere's texture coordinates come from its
camera-space normal, and a hit's tangent frame turns that normal onto the
camera-space +z axis.

A scene is a dict of float64 numpy arrays: spheres (`sph_*`), a small pool
of triangles (`tri_*`, the ganesha floor) and a mesh (`mesh_*`), each with
its material (kind 0 lambertian, 1 metal, 2 dielectric; texture 0 solid,
1 checker with `*_cwh` = (width - 1, height - 1) squares), and the sky's
two colours.
"""

from __future__ import annotations

import hashlib
import math
import struct

import numpy as np

__all__ = ["Camera", "camera", "shirley_spheres", "shirley_scene",
           "ganesha_scene"]

MATERIALS = {"lambertian": 0, "metal": 1, "dielectric": 2}


class Camera:
    """A pinhole camera: the world -> camera affine map and the film's
    extent at distance 1 (vertical field of view `vfov_deg`)."""

    def __init__(self, eye, target, up, aspect: float, vfov_deg: float):
        eye, target, up = (np.asarray(v, np.float64) for v in (eye, target,
                                                                 up))
        unit = lambda v: v / np.sqrt(v @ v)
        fwd = unit(target - eye)
        right = unit(np.cross(fwd, unit(up)))
        upv = unit(np.cross(right, fwd))
        self.rot = np.stack([right, upv, -fwd])  # rows: camera x, y, z
        self.shift = -self.rot @ eye
        self.half_h = math.tan(0.5 * math.radians(vfov_deg))
        self.half_w = aspect * self.half_h

    def to_camera(self, pts) -> np.ndarray:
        return np.asarray(pts, np.float64) @ self.rot.T + self.shift


def camera(config: dict, aspect: float) -> Camera:
    """The configuration's `camera` for a film of aspect `aspect`."""
    c = config["camera"]
    return Camera(c["eye"], c["target"], c["up"], aspect,
                  c["vertical_fov_deg"])


def _sky(config: dict) -> np.ndarray:
    return np.asarray([config["sky"]["down"], config["sky"]["up"]],
                      np.float64)


class _OCaml5Random:
    """OCaml 5's Random (the LXM L64X128 generator) seeded as `Random.init
    seed`: MD5 of the seed's little-endian int64, the second digest the MD5
    of the first. The shirley command draws its sphere list from it."""

    M64 = (1 << 64) - 1

    def __init__(self, seed: int):
        b = struct.pack("<q", ((seed + (1 << 63)) % (1 << 64)) - (1 << 63))
        d1 = hashlib.md5(b).digest()
        d2 = hashlib.md5(d1).digest()
        s, a = struct.unpack_from("<QQ", d1)
        x0, x1 = struct.unpack_from("<QQ", d2)
        self.st = [s, a | 1, x0 or 1, x1 or 2]

    def float(self) -> float:
        m = self.M64
        s, a, x0, x1 = self.st
        z = (s + x0) & m
        z = ((z ^ (z >> 32)) * 0xDABA0B6EB09322E3) & m
        z = ((z ^ (z >> 32)) * 0xDABA0B6EB09322E3) & m
        z ^= z >> 32
        s = (s * 0xD1342543DE82EF95 + a) & m
        x1 ^= x0
        x0 = (((x0 << 24) | (x0 >> 40)) & m) ^ x1 ^ ((x1 << 16) & m)
        x1 = ((x1 << 37) | (x1 >> 27)) & m
        self.st = [s, a, x0, x1]
        return (z >> 11) * 2.0 ** -53


def shirley_spheres(config: dict, seed: int) -> list[tuple]:
    """The shirley-spheres command's sphere list for `Random.init seed`:
    (center, radius, kind, colour, texture, checker squares) rows. The
    configuration's checkered lambertian `ground`, then its `big_spheres`,
    then, per cell (a, b) of its `grid`, a small sphere jittered inside the
    cell unless it falls near `clear_of` (x, z), of a material drawn per
    cell: lambertian below `lambertian_below`, metal below `metal_below`,
    glass above."""
    rng = _OCaml5Random(seed)
    g = config["ground"]
    rows = [(tuple(g["center"]), g["radius"], MATERIALS["lambertian"],
             tuple(tuple(c) for c in g["checker"]), 1, tuple(g["squares"]))]
    for s in config["big_spheres"]:
        albedo = (tuple(s["albedo"]),) if "albedo" in s else None
        rows.append((tuple(s["center"]), s["radius"],
                     MATERIALS[s["material"]], albedo, 0, None))
    gr = config["grid"]
    lo, hi = gr["cells"]
    cx, cz = gr["clear_of"]
    grey = gr["metal_grey"]
    for a in range(lo, hi + 1):
        for b in range(lo, hi + 1):
            x = a + gr["jitter"] * rng.float()
            z = b + gr["jitter"] * rng.float()
            if (x - cx) ** 2 + (z - cz) ** 2 <= gr["clear_radius2"]:
                continue
            roll = rng.float()
            c = (x, gr["y"], z)
            if roll < gr["lambertian_below"]:
                # albedo = rand_v3 * rand_v3, the second factor drawn first
                v2 = [rng.float() for _ in range(3)]
                v1 = [rng.float() for _ in range(3)]
                rows.append((c, gr["radius"], MATERIALS["lambertian"],
                             (tuple(p * q for p, q in zip(v1, v2)),), 0,
                             None))
            elif roll < gr["metal_below"]:
                v = grey["scale"] * rng.float() + grey["offset"]
                rows.append((c, gr["radius"], MATERIALS["metal"],
                             ((v, v, v),), 0, None))
            else:
                rows.append((c, gr["radius"], MATERIALS["dielectric"], None,
                             0, None))
    return rows


def _empty_scene() -> dict:
    z3 = np.zeros((0, 3))
    return dict(sph_c=z3, sph_r=np.zeros(0), sph_kind=np.zeros(0, np.int64),
                sph_tex=np.zeros(0, np.int64), sph_ca=z3, sph_cb=z3,
                sph_cwh=np.zeros((0, 2)), sph_ior=np.zeros(0),
                tri_a=z3, tri_e1=z3, tri_e2=z3, tri_uv=np.zeros((0, 3, 2)),
                tri_kind=np.zeros(0, np.int64), tri_tex=np.zeros(0, np.int64),
                tri_ca=z3, tri_cb=z3, tri_cwh=np.zeros((0, 2)),
                tri_ior=np.zeros(0), mesh_a=z3, mesh_e1=z3, mesh_e2=z3,
                mesh_albedo=np.zeros(3), sky=np.zeros((2, 3)))


def shirley_scene(config: dict, seed: int,
                  aspect: float) -> tuple[dict, Camera]:
    """The shirley configuration's scene of `Random.init seed`."""
    cam = camera(config, aspect)
    rows = shirley_spheres(config, seed)
    n = len(rows)
    sc = _empty_scene()
    sc["sph_c"] = cam.to_camera([r[0] for r in rows])
    sc["sph_r"] = np.asarray([r[1] for r in rows], np.float64)
    sc["sph_kind"] = np.asarray([r[2] for r in rows], np.int64)
    sc["sph_tex"] = np.asarray([r[4] for r in rows], np.int64)
    ca, cb = np.zeros((n, 3)), np.zeros((n, 3))
    cwh = np.zeros((n, 2))
    for i, r in enumerate(rows):
        if r[3] is not None:
            ca[i] = r[3][0]
            if len(r[3]) > 1:
                cb[i] = r[3][1]
        if r[5] is not None:
            cwh[i] = (r[5][0] - 1.0, r[5][1] - 1.0)
    sc.update(sph_ca=ca, sph_cb=cb, sph_cwh=cwh,
              sph_ior=np.full(n, float(config["ior"])), sky=_sky(config))
    return sc, cam


def ganesha_scene(config: dict, vertices, faces,
                  aspect: float) -> tuple[dict, Camera]:
    """The path-traced ganesha: the mesh `vertices[faces]` (world space) of
    the configuration's `mesh_material` (lambertian), over its checkered
    `floor`, a square of side 2 `half_side` whose plane is the camera-space
    y of the mesh's lowest point, centred under the mesh's camera-space
    box, under its `sky`."""
    cam = camera(config, aspect)
    mat, fl = config["mesh_material"], config["floor"]
    if mat["material"] != "lambertian":
        raise ValueError("the reference's mesh is lambertian only")
    v = cam.to_camera(vertices)
    faces = np.asarray(faces, np.int64)
    a, b, c = v[faces[:, 0]], v[faces[:, 1]], v[faces[:, 2]]
    lo, hi = v[faces].reshape(-1, 3).min(0), v[faces].reshape(-1, 3).max(0)
    mid = 0.5 * (lo + hi)
    s = float(fl["half_side"])
    fa = np.array([mid[0] - s, lo[1], mid[2] - s])
    fb = fa + (2 * s, 0.0, 0.0)
    fc = fb + (0.0, 0.0, 2 * s)
    fd = fa + (0.0, 0.0, 2 * s)
    sc = _empty_scene()
    sc.update(mesh_a=a, mesh_e1=b - a, mesh_e2=c - a,
              mesh_albedo=np.asarray(mat["albedo"], np.float64),
              sky=_sky(config))
    sc["tri_a"] = np.stack([fa, fa])
    sc["tri_e1"] = np.stack([fb - fa, fc - fa])
    sc["tri_e2"] = np.stack([fc - fa, fd - fa])
    sc["tri_uv"] = np.array([[(0, 0), (0, 1), (1, 1)],
                             [(0, 0), (1, 1), (1, 0)]], np.float64)
    sc["tri_kind"] = np.full(2, MATERIALS["lambertian"], np.int64)
    sc["tri_tex"] = np.ones(2, np.int64)
    sc["tri_ca"] = np.tile(fl["checker"][0], (2, 1)).astype(np.float64)
    sc["tri_cb"] = np.tile(fl["checker"][1], (2, 1)).astype(np.float64)
    sc["tri_cwh"] = np.full((2, 2), fl["squares"] - 1.0)
    sc["tri_ior"] = np.full(2, float(config["ior"]))
    return sc, cam
