"""Shirley random-spheres scene.

Port of pathtracer_tpu/models/shirley.py. The sphere list is read from the
committed manifest scenes/shirley_seed42.json, never regenerated (the JAX
package owns its generator).

  - camera eye (13,2,4.5) -> origin, up +Y, vfov 20deg
  - background: lerp(0.5*(dy+1), white, (0.5,0.7,1.0)), given to the kernels
    as (bg_mode=1, (white, sky)) — the JAX `background.pallas_params` —
    and evaluated on directions by `sky` (the JAX `background`)
"""

from __future__ import annotations

import json
import os

import torch

from ..camera import Camera
from ..ops import vec
from ..scene import DIELECTRIC, LAMBERTIAN, METAL, Scene, SceneBuilder, TEX_CHECKER

MANIFEST = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "scenes", "shirley_seed42.json"))

# (bg_mode, (color at dy=-1, color at dy=+1)): mode 1 = vertical sky lerp
BACKGROUND = (1, ((1.0, 1.0, 1.0), (0.5, 0.7, 1.0)))


def sky(background, d: torch.Tensor) -> torch.Tensor:
    """A (bg_mode, colors) background of mode 1 on unit directions d (N, 3)
    f32: lerp(0.5 (d_y + 1), colors[0], colors[1]) in the JAX op order
    (vec.lerp: a (1 - t) + b t). Returns (N, 3)."""
    mode, (lo, hi) = background
    if mode != 1:
        raise ValueError(f"sky: no background of mode {mode}")
    t = 0.5 * (d[:, 1] + 1.0)
    const = lambda c: torch.tensor(c, dtype=d.dtype,
                                   device=d.device).expand_as(d)
    return vec.lerp(t, const(lo), const(hi))


def make_camera(aspect: float) -> Camera:
    return Camera.create(eye=(13.0, 2.0, 4.5), target=(0.0, 0.0, 0.0),
                         up=(0.0, 1.0, 0.0), aspect=aspect, vertical_fov_deg=20.0)


def sphere_list(path: str = MANIFEST):
    with open(path) as f:
        return json.load(f)["spheres"]


def build(aspect: float, device) -> tuple[Scene, Camera, tuple]:
    """Returns (scene in camera space on `device`, camera, background)."""
    cam = make_camera(aspect)
    b = SceneBuilder()
    for s in sphere_list():
        kind = s["kind"]
        if kind == "checker_lambert":
            b.add_sphere(s["center"], s["radius"], LAMBERTIAN,
                         color_a=s["even"], color_b=s["odd"],
                         tex_kind=TEX_CHECKER, checker_wh=s["checker"])
        elif kind == "lambert":
            b.add_sphere(s["center"], s["radius"], LAMBERTIAN, color_a=s["color"])
        elif kind == "metal":
            b.add_sphere(s["center"], s["radius"], METAL, color_a=s["color"])
        elif kind == "glass":
            b.add_sphere(s["center"], s["radius"], DIELECTRIC, ior=1.5)
        else:
            raise ValueError(kind)
    return b.build(camera=cam, device=device), cam, BACKGROUND
