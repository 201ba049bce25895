"""Entry `pt_subdivided`: entry `pt`'s path tracer on the committed mesh
split 4:1 at its edge midpoints, `subdivide` times (a scan past the BVH8
table's range from the committed one).

The committed file is read and checked against its recorded digest and
sizes as entry `pt` does; it is split in float64 (`split`: one new vertex
at the midpoint of each undirected edge, shared by the faces on both
sides, so a closed surface stays closed and the surface is unchanged),
checked against the configuration's `subdivided_vertices` and
`subdivided_triangles`, then turned by the seed's yaw, which rounds it to
float32 (`meshes.yawed`). The program builds its scene from that mesh
written as a PLY file (`models.ganesha.build_pt`, whose MeshBVH takes the
walk table it can) and renders it as entry `pt` does; the reference takes
the same float32 vertices and faces.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np
from torch.profiler import record_function

from .. import meshes
from ..spec import ROOT
from . import pt

__all__ = ["split", "Inputs", "Entry"]


def split(verts: np.ndarray, faces: np.ndarray):
    """One 4:1 midpoint split: (vertices (V + E, 3) float64, faces (4F, 3)
    int64), the V vertices first, then one midpoint per undirected edge in
    the order of the edges' sorted keys; face f's four children are rows
    f, F + f, 2F + f and 3F + f: its three corners, then the middle."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    n = len(verts)
    key = np.minimum(e[:, 0], e[:, 1]) * n + np.maximum(e[:, 0], e[:, 1])
    uniq, inv = np.unique(key, return_inverse=True)
    mids = 0.5 * (verts[uniq // n] + verts[uniq % n])
    m01, m12, m20 = (n + inv.reshape(-1)).reshape(3, -1)
    a, b, c = faces.T
    out = [np.stack(t, axis=1) for t in ((a, m01, m20), (m01, b, m12),
                                         (m20, m12, c), (m01, m12, m20))]
    return np.concatenate([verts, mids]), np.concatenate(out)


def _mesh_input(config: dict, seed: int):
    """The committed mesh, checked against its recorded digest and sizes,
    split `subdivide` times in float64 and checked again, turned by the
    seed's yaw: (float32 vertices, faces)."""
    path = os.path.join(ROOT, config["mesh"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != config["mesh_sha256"]:
        raise ValueError(f"{config['mesh']}: sha256 {digest} is not the "
                         f"configuration's {config['mesh_sha256']}")
    verts, faces = meshes.read_ply(path)
    if (len(verts), len(faces)) != (config["mesh_vertices"],
                                    config["mesh_triangles"]):
        raise ValueError(f"{config['mesh']}: {len(verts)} vertices and "
                         f"{len(faces)} triangles, not the configuration's")
    verts = verts.astype(np.float64)
    for _ in range(int(config["subdivide"])):
        verts, faces = split(verts, faces)
    if (len(verts), len(faces)) != (config["subdivided_vertices"],
                                    config["subdivided_triangles"]):
        raise ValueError(f"{config['mesh']} split {config['subdivide']} "
                         f"times: {len(verts)} vertices and {len(faces)} "
                         "triangles, not the configuration's")
    return meshes.yawed(verts, seed), faces


class Inputs(pt.Inputs):
    """entry pt's Inputs over the split mesh."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        if config["scene"] != "ganesha":
            raise ValueError(f"entry pt_subdivided: no scene "
                             f"{config['scene']!r}")
        self.config, self.traffic, self.seed = config, traffic, seed
        t = traffic
        self.size = (t["width"], t["height"], t["spp"], t["max_bounces"])
        self.verts, self.faces = _mesh_input(config, seed)


class Entry(pt.Entry):
    """entry pt's Entry over the split mesh: the program's scene built from
    it by models.ganesha.build_pt. sizes() gives the split's triangles."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pathtracer_tpu_torch.integrator import make_render_fn
        from pathtracer_tpu_torch.models import ganesha
        self.inputs = Inputs(config, traffic, seed)
        self.config, self.seed, self.device = config, seed, device
        w, h, spp, bounces = self.inputs.size
        self.mesh_file = meshes.temp_path(f"ganesha_sub_{seed}.ply")
        meshes.write_ply(self.mesh_file, self.inputs.verts,
                         self.inputs.faces)
        t0 = time.perf_counter()
        with record_function("port_bench.scene_build"):
            self.scene, cam, bg, mesh = ganesha.build_pt(self.mesh_file,
                                                         w / h, device)
        self.build_s = time.perf_counter() - t0
        self.render = make_render_fn(cam, bg, w, h, spp, bounces, device,
                                     mesh=mesh)
