"""Scene representation: structure-of-arrays sphere geometry + materials.

Port of pathtracer_tpu/scene.py (sphere scenes only; triangle pools belong to
the cornell-box slice, not ported yet). Fields and the (S, 16) `shade_pack`
column layout are the JAX Scene's, as torch tensors.

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


@dataclass(frozen=True)
class Scene:
    """SoA sphere scene in camera space, padded to a multiple of 8 spheres."""

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

    @property
    def count(self) -> int:
        return self.center.shape[0]

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> "Scene":
        """Build from the JAX Scene's arrays (`np.asarray` of each field).
        Fields the JAX Scene leaves None may be absent or None; a scene with
        triangles is refused (not ported)."""
        if arrays.get("tri_pack") is not None:
            raise ValueError("triangle scenes are not ported yet")
        dtypes = {"mat_kind": np.int32, "tex_kind": np.int32, "valid": bool}
        return cls(**{
            f.name: torch.as_tensor(
                np.array(arrays[f.name], dtypes.get(f.name, np.float32)),
                device=device)
            for f in fields(cls)})


class SceneBuilder:
    """Host-side accumulation of spheres; produces a padded Scene."""

    def __init__(self):
        self.rows = []

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
        return Scene.from_numpy(dict(
            center=center, radius=radius, mat_kind=mat_kind,
            tex_kind=tex_kind, color_a=color_a, color_b=color_b,
            checker_w=checker_w, checker_h=checker_h, ior=ior,
            ior_inv=1.0 / ior, valid=valid, shade_pack=pack), device)
