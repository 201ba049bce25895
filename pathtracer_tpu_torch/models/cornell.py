"""Cornell-box scene, rendered by the progressive photon mapper.

Port of pathtracer_tpu/models/cornell.py, the same host float64 build:
  - unit box walls as 2-triangle quads: right red, left blue, floor 10x10
    checker, ceiling and rear grey;
  - an open metal light-box enclosure around the point light;
  - a metal and a glass sphere, plus a huge lambertian sphere behind the
    camera that stops photons from escaping;
  - a point light of power 2.0 at (0.5, 0.82, 0.5);
  - camera eye (0.5, 0.5, -1) -> (0.5, 0.5, 0), vfov = 2 atan(0.5).
18 triangles (padded to 128) and 3 spheres (padded to 8).
"""

from __future__ import annotations

import math

import numpy as np

from ..camera import Camera
from ..ppm import Light
from ..scene import DIELECTRIC, LAMBERTIAN, METAL, TEX_CHECKER, SceneBuilder


def make_camera(aspect: float) -> Camera:
    vfov = math.degrees(2.0 * math.atan(0.5))
    return Camera.create(eye=(0.5, 0.5, -1.0), target=(0.5, 0.5, 0.0),
                         up=(0.0, 1.0, 0.0), aspect=aspect,
                         vertical_fov_deg=vfov)


def build(aspect: float, device):
    """(scene on `device`, camera, [Light])."""
    cam = make_camera(aspect)
    b = SceneBuilder()

    red = dict(mat_kind=LAMBERTIAN, color_a=(0.7, 0.0, 0.0))
    blue = dict(mat_kind=LAMBERTIAN, color_a=(0.0, 0.0, 0.7))
    grey = dict(mat_kind=LAMBERTIAN, color_a=(0.7, 0.7, 0.7))
    checker = dict(mat_kind=LAMBERTIAN, color_a=(0.2, 0.3, 0.1),
                   color_b=(0.9, 0.9, 0.9), tex_kind=TEX_CHECKER,
                   checker_wh=(10, 10))
    ex, ey, ez = (1, 0, 0), (0, 1, 0), (0, 0, 1)
    # light enclosure first (the reference's shape order)
    lc = np.array([0.5, 0.82, 0.5])
    r = 0.05
    rx, ry, rz = (np.eye(3) * r)
    metal_green = dict(mat_kind=METAL, color_a=(0.30, 0.999, 0.30))
    a = lc - rx - ry - rz
    bb = lc + rx - ry + rz
    b.add_quad(a, 2 * rz, 2 * ry, **metal_green)
    b.add_quad(a, 2 * ry, 2 * rx, **metal_green)
    b.add_quad(bb, -2 * rz, 2 * ry, **metal_green)
    b.add_quad(bb, 2 * rx, 2 * ry, **metal_green)
    # box walls
    b.add_quad((0, 0, 0), ez, ey, **red)  # right wall
    b.add_quad((1, 0, 0), ez, ey, **blue)  # left wall
    b.add_quad((0, 0, 0), ex, ez, **checker)  # floor
    b.add_quad((0, 1, 0), ex, ez, **grey)  # ceiling
    b.add_quad((0, 0, 1), ex, ey, **grey)  # rear wall
    # spheres
    sr = 0.20
    b.add_sphere((1.0 - 0.1 - sr, sr, 1.0 - 0.2 - sr), sr, METAL,
                 color_a=(1.0, 1.0, 1.0))
    b.add_sphere((0.1 + sr, 0.1 + sr, 0.2 + sr), sr, DIELECTRIC, ior=1.5)
    b.add_sphere((0.5, 0.5, -2.0 - 10.0), 10.0, LAMBERTIAN,
                 color_a=(0.75, 0.75, 0.75))

    scene = b.build(cam, device)
    light_pos = cam.transform_points(np.array([[0.5, 0.82, 0.5]]))[0]
    lights = [Light.point(light_pos, power=2.0)]
    return scene, cam, lights
