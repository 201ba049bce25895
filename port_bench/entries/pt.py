"""Entry `pt`: the port's path tracer, one whole image per call.

The program's side: the scene is built with the port's own builders
(`models.shirley.build(..., seed=, use_manifest=False)` from the run's
seed, or `models.ganesha.build_pt` from the yawed mesh file) and rendered
by `integrator.make_render_fn`; an image ends when its finished image is on
the host as an array. The reference's side: the same scene worked out
again by `reference.scenes` from the configuration file and the same
inputs, rendered by `reference.pt`.
"""

from __future__ import annotations

import hashlib
import os
import time

import torch
from torch.profiler import record_function

from .. import meshes
from ..spec import ROOT

__all__ = ["Inputs", "Entry"]


def _mesh_input(config: dict, seed: int):
    """The committed mesh, checked against its recorded digest and sizes,
    turned by the seed's yaw: (float32 vertices, faces)."""
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
    return meshes.yawed(verts, seed), faces


class Inputs:
    """A run's inputs and the reference's side: the image's size, for
    ganesha the yawed mesh (float32 vertices and faces) that both sides
    take, and the reference's image of the run's scene."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        self.config, self.traffic, self.seed = config, traffic, seed
        t = traffic
        self.size = (t["width"], t["height"], t["spp"], t["max_bounces"])
        if config["scene"] == "ganesha":
            self.verts, self.faces = _mesh_input(config, seed)

    def reference(self, device, dtype=torch.float64, **kw):
        """The reference's (image, segments) of the run's scene."""
        from ..reference import pt, scenes
        w, h, spp, bounces = self.size
        if self.config["scene"] == "ganesha":
            sc, cam = scenes.ganesha_scene(self.config, self.verts,
                                           self.faces, w / h)
        else:
            sc, cam = scenes.shirley_scene(self.config, self.seed, w / h)
        return pt.render(sc, cam, w, h, spp, bounces, device, dtype, **kw)


class Entry:
    """One cell's program state: `image()` renders one image and returns
    (image (H, W, 3) float32 numpy, segments int). `build_s` is the host
    time of the set-up's scene-build calls; `inputs` the run's Inputs."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pathtracer_tpu_torch.integrator import make_render_fn
        self.inputs = Inputs(config, traffic, seed)
        self.config, self.seed, self.device = config, seed, device
        w, h, spp, bounces = self.inputs.size
        self.mesh_file = None
        kind = config["scene"]
        if kind == "shirley":
            from pathtracer_tpu_torch.models import shirley
            t0 = time.perf_counter()
            with record_function("port_bench.scene_build"):
                self.scene, cam, bg = shirley.build(w / h, device, seed=seed,
                                                    use_manifest=False)
            self.build_s = time.perf_counter() - t0
            self.render = make_render_fn(cam, bg, w, h, spp, bounces, device)
        elif kind == "ganesha":
            from pathtracer_tpu_torch.models import ganesha
            self.mesh_file = meshes.temp_path(f"ganesha_{seed}.ply")
            meshes.write_ply(self.mesh_file, self.inputs.verts,
                             self.inputs.faces)
            t0 = time.perf_counter()
            with record_function("port_bench.scene_build"):
                self.scene, cam, bg, mesh = ganesha.build_pt(
                    self.mesh_file, w / h, device)
            self.build_s = time.perf_counter() - t0
            self.render = make_render_fn(cam, bg, w, h, spp, bounces, device,
                                         mesh=mesh)
        else:
            raise ValueError(f"entry pt: no scene {kind!r}")

    def image(self):
        with record_function("port_bench.render"):
            img, segments = self.render(self.scene)
        with record_function("port_bench.to_host"):
            host = img.cpu().numpy()
        return host, int(segments)

    def sizes(self) -> dict:
        """The scene sizes the byte counts of the per-layer metrics read."""
        if self.config["scene"] == "ganesha":
            return {"spheres": 0, "mesh_triangles": len(self.inputs.faces)}
        return {"spheres": int(self.scene.valid.sum()), "mesh_triangles": 0}

    def release(self) -> None:
        """Drop the program's state and its file."""
        self.scene = self.render = None
        if self.mesh_file and os.path.exists(self.mesh_file):
            os.remove(self.mesh_file)
