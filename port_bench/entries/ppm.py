"""Entry `ppm`: the port's progressive photon mapper, one whole image per
call.

The program's side: the yawed mesh file (entries/pt.py's mesh input) is
built by the port's own builder, `models.ganesha.build`, which returns the
floor, the camera, the two spot lights and the mesh, and one
`ppm.PPMRenderer` at the traffic's sizes is kept for the run, with its
tile table, as a process that renders many images of one scene keeps it.
An image is one `render()`: its iterations' sum over the iteration count,
the linear averaged image before gamma, as float32 on the host; its count
is the photon ray segments summed over its iterations. The reference's
side: the same scene and lights worked out again by `reference.ppm.scene`
from the configuration file and the same mesh, rendered by
`reference.ppm`.
"""

from __future__ import annotations

import os
import time

import torch
from torch.profiler import record_function

from .. import meshes
from .pt import _mesh_input

__all__ = ["Inputs", "Entry"]


class Inputs:
    """A run's inputs and the reference's side: the image's size and the
    photon mapper's parameters, the yawed mesh (float32 vertices and
    faces) that both sides take, and the reference's image of the run's
    scene."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        if config["scene"] != "ganesha":
            raise ValueError(f"entry ppm: no scene {config['scene']!r}")
        self.config, self.traffic, self.seed = config, traffic, seed
        t = traffic
        self.size = (t["width"], t["height"])
        self.params = dict(iterations=t["iterations"],
                           photon_count=t["photon_count"],
                           alpha=config["ppm"]["alpha"],
                           max_bounces=t["max_bounces"])
        self.verts, self.faces = _mesh_input(config, seed)

    def reference(self, device, dtype=torch.float64, **kw):
        """The reference's (image, photon segments) of the run's scene."""
        from ..reference import ppm
        w, h = self.size
        sc, cam, lights = ppm.scene(self.config, self.verts, self.faces,
                                    w / h)
        return ppm.render(sc, cam, lights, w, h, device=device, dtype=dtype,
                          **self.params, **kw)


class Entry:
    """One cell's program state: `image()` renders one image and returns
    (image (H, W, 3) float32 numpy, photon segments int). `build_s` is the
    host time of the set-up's scene build; `inputs` the run's Inputs."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pathtracer_tpu_torch.models import ganesha
        from pathtracer_tpu_torch.ppm import PPMRenderer
        self.inputs = Inputs(config, traffic, seed)
        w, h = self.inputs.size
        self.mesh_file = meshes.temp_path(f"ganesha_spots_{seed}.ply")
        meshes.write_ply(self.mesh_file, self.inputs.verts, self.inputs.faces)
        t0 = time.perf_counter()
        with record_function("port_bench.scene_build"):
            scene, cam, lights, mesh = ganesha.build(self.mesh_file, w / h,
                                                     device)
        self.build_s = time.perf_counter() - t0
        self.renderer = PPMRenderer(scene, cam, lights, w, h, verbose=False,
                                    mesh=mesh, **self.inputs.params)

    def image(self):
        r = self.renderer
        with record_function("port_bench.render"):
            img_sum = r.render()
        with record_function("port_bench.to_host"):
            host = (img_sum / r.iterations).to(torch.float32).cpu().numpy()
            segments = int(torch.stack([s for s, _ in r.iter_segments]).sum())
        return host, segments

    def sizes(self) -> dict:
        """The scene sizes the byte counts of the per-layer metrics read."""
        return {"spheres": 0, "mesh_triangles": len(self.inputs.faces)}

    def release(self) -> None:
        """Drop the program's state and its file."""
        self.renderer = None
        if os.path.exists(self.mesh_file):
            os.remove(self.mesh_file)
