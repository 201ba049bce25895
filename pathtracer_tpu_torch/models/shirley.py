"""Shirley random-spheres scene.

Port of pathtracer_tpu/models/shirley.py:
  - ground: checker lambertian sphere r=1000 at (0,-1000,0), checker 1000x2000,
    even (0.2,0.3,0.1), odd (0.9,0.9,0.9)
  - three unit spheres: glass at (-4,1,0), metal(0.7,0.6,0.5) at (0,1,0),
    lambertian(0.1,0.1,0.7) at (4,1,0)
  - grid a,b in [-11,11]^2 (a outer, b inner): center (a+0.9*rand, 0.2,
    b+0.9*rand), kept if quadrance(center-(4,0.2,0)) > 0.81; material roll:
    <0.8 lambertian(albedo = rand_v3 * rand_v3), <0.95 metal(grey in
    [0.5,1)), else glass; the draws from the OCaml 5 stream of
    utils/ocaml_random.py seeded with `seed`
  - the sphere list of `sphere_list` as in the JAX package: the committed
    manifest scenes/shirley_seed42.json whenever it exists, whatever the
    seed (use_manifest=False generates the seed's own list), and written
    from the seed's list when it is missing
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
from ..utils import tracing
from ..utils.ocaml_random import OCaml5Random

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


def generate_sphere_list(seed: int = 42):
    """Recreate the reference's sphere list as plain python data (the JAX
    generate_sphere_list, draw for draw)."""
    rng = OCaml5Random(seed)
    spheres = []

    def add(center, radius, kind, **kw):
        spheres.append(dict(center=list(center), radius=radius, kind=kind, **kw))

    add((0.0, -1000.0, 0.0), 1000.0, "checker_lambert",
        even=[0.2, 0.3, 0.1], odd=[0.9, 0.9, 0.9], checker=[1000, 2000])
    add((-4.0, 1.0, 0.0), 1.0, "glass")
    add((0.0, 1.0, 0.0), 1.0, "metal", color=[0.7, 0.6, 0.5])
    add((4.0, 1.0, 0.0), 1.0, "lambert", color=[0.1, 0.1, 0.7])

    for a in range(-11, 12):
        for b in range(-11, 12):
            x = a + 0.9 * rng.float(1.0)
            z = b + 0.9 * rng.float(1.0)
            radius = 0.2
            cx, cy, cz = x, radius, z
            dx, dy, dz = cx - 4.0, cy - radius, cz - 0.0
            if dx * dx + dy * dy + dz * dz > 0.81:
                roll = rng.float(1.0)
                if roll < 0.8:
                    # albedo = rand_v3 * rand_v3; OCaml evaluates the args
                    # right-to-left but componentwise product commutes
                    v2 = [rng.float(1.0) for _ in range(3)]
                    v1 = [rng.float(1.0) for _ in range(3)]
                    color = [v1[i] * v2[i] for i in range(3)]
                    add((cx, cy, cz), radius, "lambert", color=color)
                elif roll < 0.95:
                    g = 0.5 * rng.float(1.0) + 0.5
                    add((cx, cy, cz), radius, "metal", color=[g, g, g])
                else:
                    add((cx, cy, cz), radius, "glass")
    return spheres


def sphere_list(seed: int = 42, use_manifest: bool = True):
    """The JAX sphere_list: the manifest when use_manifest and it exists
    (whatever the seed), else the seed's generated list, written to the
    manifest when use_manifest."""
    if use_manifest and os.path.exists(MANIFEST):
        with open(MANIFEST) as f:
            return json.load(f)["spheres"]
    spheres = generate_sphere_list(seed)
    if use_manifest:
        os.makedirs(os.path.dirname(MANIFEST), exist_ok=True)
        with open(MANIFEST, "w") as f:
            json.dump({"seed": seed, "spheres": spheres}, f, indent=1)
    return spheres


def build(aspect: float, device, seed: int = 42,
          use_manifest: bool = True) -> tuple[Scene, Camera, tuple]:
    """Returns (scene in camera space on `device`, camera, background) of
    sphere_list(seed, use_manifest)."""
    with tracing.span("build.scene"):
        cam = make_camera(aspect)
        b = SceneBuilder()
        for s in sphere_list(seed, use_manifest):
            kind = s["kind"]
            if kind == "checker_lambert":
                b.add_sphere(s["center"], s["radius"], LAMBERTIAN,
                             color_a=s["even"], color_b=s["odd"],
                             tex_kind=TEX_CHECKER, checker_wh=s["checker"])
            elif kind == "lambert":
                b.add_sphere(s["center"], s["radius"], LAMBERTIAN,
                             color_a=s["color"])
            elif kind == "metal":
                b.add_sphere(s["center"], s["radius"], METAL,
                             color_a=s["color"])
            elif kind == "glass":
                b.add_sphere(s["center"], s["radius"], DIELECTRIC, ior=1.5)
            else:
                raise ValueError(kind)
        return b.build(camera=cam, device=device), cam, BACKGROUND
