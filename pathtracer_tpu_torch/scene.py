"""Scene representation: structure-of-arrays spheres and triangles +
materials.

Port of pathtracer_tpu/scene.py: the sphere pool and the optional triangle
pool of mixed scenes (cornell-box). Fields, the (S, 16) `shade_pack` column
layout and the (T, 27) `tri_pack` column layout are the JAX Scene's, as torch
tensors.

Material codes: 0=Lambertian, 1=Metal, 2=Dielectric.
Texture codes: 0=solid (color_a), 1=checker (color_a even / color_b odd).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2

TEX_SOLID = 0
TEX_CHECKER = 1


# tri_pack column layout
TRI_A = slice(0, 3)
TRI_E1 = slice(3, 6)
TRI_E2 = slice(6, 9)
TRI_TEX = slice(9, 15)  # ua va ub vb uc vc
TRI_MAT = slice(15, 27)  # the 12 columns of shade_pack[4:16]


@dataclass(frozen=True)
class Scene:
    """SoA scene in camera space: spheres padded to a multiple of 8, and an
    optional triangle pool (a + u*e1 + v*e2) padded to a multiple of 128."""

    center: torch.Tensor  # (S, 3) f32
    radius: torch.Tensor  # (S,) f32
    mat_kind: torch.Tensor  # (S,) i32
    tex_kind: torch.Tensor  # (S,) i32
    color_a: torch.Tensor  # (S, 3) f32 — solid color / checker even color
    color_b: torch.Tensor  # (S, 3) f32 — checker odd color
    checker_w: torch.Tensor  # (S,) f32 — checker width-1
    checker_h: torch.Tensor  # (S,) f32 — checker height-1
    ior: torch.Tensor  # (S,) f32 — dielectric index
    ior_inv: torch.Tensor  # (S,) f32
    valid: torch.Tensor  # (S,) bool — False for padding entries
    shade_pack: torch.Tensor  # (S, 16) f32 — all shading params per sphere
    tri_pack: torch.Tensor = None  # (T, 27) f32: a e1 e2 tex(6) mat(12)
    tri_valid: torch.Tensor = None  # (T,) bool

    @property
    def count(self) -> int:
        return self.center.shape[0]

    @property
    def tri_count(self) -> int:
        return 0 if self.tri_pack is None else self.tri_pack.shape[0]

    def bbox(self):
        """Host float64 (lo, hi) over the valid spheres and triangles."""
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        valid = self.valid.cpu().numpy()
        c = self.center.cpu().numpy()[valid]
        r = self.radius.cpu().numpy()[valid][:, None]
        if len(c):
            lo = np.minimum(lo, (c - r).min(0))
            hi = np.maximum(hi, (c + r).max(0))
        if self.tri_count:
            tp = self.tri_pack.cpu().numpy()[self.tri_valid.cpu().numpy()]
            if len(tp):
                a = tp[:, TRI_A]
                v = np.concatenate([a, a + tp[:, TRI_E1], a + tp[:, TRI_E2]])
                lo = np.minimum(lo, v.min(0))
                hi = np.maximum(hi, v.max(0))
        return lo, hi

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> "Scene":
        """Build from the JAX Scene's arrays (`np.asarray` of each field).
        The triangle pool (tri_pack, tri_valid) may be absent or None (also
        as `np.asarray(None)`), as may the fields the port does not keep."""
        dtypes = {"mat_kind": np.int32, "tex_kind": np.int32, "valid": bool,
                  "tri_valid": bool}
        out = {}
        for f in fields(cls):
            x = arrays.get(f.name)
            if x is not None and np.asarray(x).dtype == object:
                x = None  # np.asarray of a field the JAX Scene left None
            if x is None and f.default is None:
                out[f.name] = None
                continue
            out[f.name] = torch.as_tensor(
                np.array(x, dtypes.get(f.name, np.float32)), device=device)
        return cls(**out)


class SceneBuilder:
    """Host-side accumulation of spheres and triangles; produces a padded
    Scene."""

    def __init__(self):
        self.rows = []
        self.tris = []

    def add_sphere(self, center, radius, mat_kind, color_a=(0, 0, 0),
                   color_b=(0, 0, 0), tex_kind=TEX_SOLID, checker_wh=(1, 1),
                   ior=1.5):
        self.rows.append(dict(
            center=np.asarray(center, np.float64), radius=float(radius),
            mat_kind=int(mat_kind), tex_kind=int(tex_kind),
            color_a=np.asarray(color_a, np.float64),
            color_b=np.asarray(color_b, np.float64),
            checker_wh=(float(checker_wh[0]), float(checker_wh[1])),
            ior=float(ior)))

    def add_triangle(self, a, b, c, mat_kind, tex_a=(0, 0), tex_b=(0, 0),
                     tex_c=(0, 0), color_a=(0, 0, 0), color_b=(0, 0, 0),
                     tex_kind=TEX_SOLID, checker_wh=(1, 1), ior=1.5):
        self.tris.append(dict(
            verts=np.asarray([a, b, c], np.float64),
            tex=np.asarray([tex_a, tex_b, tex_c], np.float64),
            mat_kind=int(mat_kind), tex_kind=int(tex_kind),
            color_a=np.asarray(color_a, np.float64),
            color_b=np.asarray(color_b, np.float64),
            checker_wh=(float(checker_wh[0]), float(checker_wh[1])),
            ior=float(ior)))

    def add_quad(self, a, u, v, **mat):
        """Axis quad as a 2-triangle fan in the reference's winding: corners
        a, b = a+v, c = b+u, d = a+u with tex coords t00, t10, t11, t01;
        triangles (a, b, c) and (a, c, d)."""
        a = np.asarray(a, np.float64)
        u = np.asarray(u, np.float64)
        v = np.asarray(v, np.float64)
        b, c, d = a + v, a + v + u, a + u
        t00, t10, t11, t01 = (0, 0), (1, 0), (1, 1), (0, 1)
        self.add_triangle(a, b, c, tex_a=t00, tex_b=t10, tex_c=t11, **mat)
        self.add_triangle(a, c, d, tex_a=t00, tex_b=t11, tex_c=t01, **mat)

    def _tri_arrays(self, camera):
        """(tri_pack (T, 27) f64, tri_valid (T,)) with T a multiple of 128,
        or (None, None) without triangles."""
        if not self.tris:
            return None, None
        tcap = -(-len(self.tris) // 128) * 128
        tp = np.zeros((tcap, 27), np.float64)
        tv = np.zeros(tcap, bool)
        for i, tr in enumerate(self.tris):
            verts = tr["verts"]
            if camera is not None:
                verts = camera.transform_points(verts)
            tp[i, TRI_A] = verts[0]
            tp[i, TRI_E1] = verts[1] - verts[0]
            tp[i, TRI_E2] = verts[2] - verts[0]
            tp[i, TRI_TEX] = tr["tex"].reshape(-1)
            tp[i, 15] = tr["mat_kind"]
            tp[i, 16] = tr["tex_kind"]
            tp[i, 17:20] = tr["color_a"]
            tp[i, 20:23] = tr["color_b"]
            tp[i, 23] = tr["checker_wh"][0] - 1.0
            tp[i, 24] = tr["checker_wh"][1] - 1.0
            tp[i, 25] = tr["ior"]
            tp[i, 26] = 1.0 / tr["ior"]
            tv[i] = True
        return tp, tv

    def build(self, camera, device, pad_to: int = 8) -> Scene:
        """Host float64 assembly (as the JAX builder), one cast to float32,
        then tensors on `device`. camera: None keeps world space."""
        n = len(self.rows)
        s = max(pad_to, -(-n // pad_to) * pad_to)
        center = np.zeros((s, 3), np.float64)
        radius = np.zeros(s, np.float64)
        mat_kind = np.zeros(s, np.int32)
        tex_kind = np.zeros(s, np.int32)
        color_a = np.zeros((s, 3), np.float64)
        color_b = np.zeros((s, 3), np.float64)
        checker_w = np.ones(s, np.float64)
        checker_h = np.ones(s, np.float64)
        ior = np.full(s, 1.5, np.float64)
        valid = np.zeros(s, bool)
        for i, r in enumerate(self.rows):
            center[i] = r["center"]
            radius[i] = r["radius"]
            mat_kind[i] = r["mat_kind"]
            tex_kind[i] = r["tex_kind"]
            color_a[i] = r["color_a"]
            color_b[i] = r["color_b"]
            # checker scales by (width-1, height-1)
            checker_w[i] = r["checker_wh"][0] - 1.0
            checker_h[i] = r["checker_wh"][1] - 1.0
            ior[i] = r["ior"]
            valid[i] = True
        if camera is not None:
            center[:n] = camera.transform_points(center[:n])
        pack = np.zeros((s, 16), np.float64)
        pack[:, 0:3] = center
        pack[:, 3] = radius
        pack[:, 4] = mat_kind
        pack[:, 5] = tex_kind
        pack[:, 6:9] = color_a
        pack[:, 9:12] = color_b
        pack[:, 12] = checker_w
        pack[:, 13] = checker_h
        pack[:, 14] = ior
        pack[:, 15] = 1.0 / ior
        tri_pack, tri_valid = self._tri_arrays(camera)
        return Scene.from_numpy(dict(
            center=center, radius=radius, mat_kind=mat_kind,
            tex_kind=tex_kind, color_a=color_a, color_b=color_b,
            checker_w=checker_w, checker_h=checker_h, ior=ior,
            ior_inv=1.0 / ior, valid=valid, shade_pack=pack,
            tri_pack=tri_pack, tri_valid=tri_valid), device)


def eval_texture(tex_kind, color_a, color_b, checker_w, checker_h, u, v):
    """Masked texture evaluation: solid color_a, or the checker's color_a
    where trunc(u * checker_w) and trunc(v * checker_h) have equal parity,
    else color_b."""
    px = torch.trunc(u * checker_w).to(torch.int32) & 1
    py = torch.trunc(v * checker_h).to(torch.int32) & 1
    checker = torch.where((px == py)[..., None], color_a, color_b)
    return torch.where((tex_kind == TEX_CHECKER)[..., None], checker, color_a)
