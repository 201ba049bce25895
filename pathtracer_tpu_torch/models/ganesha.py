"""Ganesha PLY scene: a PLY triangle mesh over a huge checkered floor, lit
by two spot lights, rendered by progressive photon mapping (build), or the
same mesh and floor under the shirley sky, path traced (build_pt).

Port of pathtracer_tpu/models/ganesha.py (make_camera, load_mesh, build,
build_pt). The mesh rides the BVH8 walk (ops.bvh.MeshBVH), or the BVH4
walk past the BVH8 table's 24-bit entries (about 1.5M triangles); the
2-triangle floor sits in the scene's triangle pool, the reference's
floor-then-mesh intersect expressed as nearest-of-pools.
"""

from __future__ import annotations

import numpy as np

from ..camera import Camera
from ..io import ply
from ..ops.bvh import MeshBVH
from ..ppm import Light
from ..scene import LAMBERTIAN, TEX_CHECKER, SceneBuilder
from ..utils import tracing
from . import shirley


def make_camera(aspect: float) -> Camera:
    return Camera.create(eye=(328.0, 70.282, 345.0), target=(328.0, 10.0, 0.0),
                         up=(-0.00212272, 0.998201, -0.0599264),
                         aspect=aspect, vertical_fov_deg=30.0)


def load_mesh(path: str, camera: Camera, device) -> MeshBVH:
    """The PLY's triangles in camera space as a MeshBVH on `device`, with
    the lambertian (0.1, 0.7, 0.2) material. watertight: the shell (a
    displaced closed UV sphere) never shows a back-facing nearest hit to
    rays from outside, so the tile lists may be back-face culled."""
    p = ply.load(path)
    verts_el = p.data.get("vertex")
    if verts_el is None:
        raise ValueError("PLY has no vertex element")
    verts = np.stack([np.asarray(verts_el[k], np.float64)
                      for k in ("x", "y", "z")], axis=1)
    faces = None
    for cols in p.data.values():
        if "vertex_indices" in cols:
            faces = cols["vertex_indices"]
    if faces is None:
        raise ValueError("PLY has no vertex_indices")
    if isinstance(faces, list):
        faces = np.stack([f for f in faces if len(f) == 3])
    faces = np.asarray(faces)
    if faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError("expected triangular faces")
    if not ((faces >= 0) & (faces < len(verts))).all():
        raise ValueError("face index out of bounds")
    verts_cam = camera.transform_points(verts)
    mat_row = np.zeros(12, np.float32)
    mat_row[0] = LAMBERTIAN
    mat_row[2:5] = (0.1, 0.7, 0.2)
    mat_row[10] = 1.5
    mat_row[11] = 1.0 / 1.5
    return MeshBVH(verts_cam, faces, mat_row, device, watertight=True)


def build(path: str, aspect: float, device):
    """Returns (scene [the floor only] on `device`, camera, lights, mesh).
    PPMRenderer takes the initial radius from the mesh's box. The build is
    one build.scene span of utils.tracing, the mesh's hierarchy, walk
    table and upload a build.mesh_bvh span inside it (MeshBVH)."""
    with tracing.span("build.scene"):
        return _build(path, aspect, device)


def _build(path: str, aspect: float, device):
    cam = make_camera(aspect)
    mesh = load_mesh(path, cam, device)
    lo, hi = mesh.bbox_lo.astype(np.float64), mesh.bbox_hi.astype(np.float64)
    center = 0.5 * (lo + hi)

    # the floor, already in camera space
    s = 5000.0
    fc = np.array([center[0], lo[1], center[2]])
    xv = np.array([s, 0.0, 0.0])
    zv = np.array([0.0, 0.0, s])
    a = fc - xv - zv  # t00
    b = a + 2.0 * xv  # t01
    c = b + 2.0 * zv  # t11
    d = a + 2.0 * zv  # t10
    checker = dict(mat_kind=LAMBERTIAN, color_a=(0.2, 0.3, 0.1),
                   color_b=(0.9, 0.9, 0.9), tex_kind=TEX_CHECKER,
                   checker_wh=(500, 500))
    sb = SceneBuilder()
    sb.add_triangle(a, b, c, tex_a=(0, 0), tex_b=(0, 1), tex_c=(1, 1),
                    **checker)
    sb.add_triangle(a, c, d, tex_a=(0, 0), tex_b=(1, 1), tex_c=(1, 0),
                    **checker)
    scene = sb.build(None, device)

    # two spot lights; the box is in camera space
    v = hi - center
    pos1 = hi + 3.0 * v + np.array([0.0, 0.0, -400.0])
    lights = [
        Light.spot(pos1, center - pos1, power=10000.0),
        Light.spot((0.0, 0.0, 1.0), (0.0, 0.0, -1.0), power=3000.0),
    ]
    return scene, cam, lights, mesh


def build_pt(path: str, aspect: float, device):
    """The path-traced ganesha: build's mesh and floor under the shirley
    sky instead of the spot lights. Returns (scene on `device`, camera,
    background (shirley.BACKGROUND), mesh); render it with
    integrator.make_render_fn(..., mesh=mesh)."""
    scene, cam, _lights, mesh = build(path, aspect, device)
    return scene, cam, shirley.BACKGROUND, mesh
