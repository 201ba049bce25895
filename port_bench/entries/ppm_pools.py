"""Entry `ppm_pools`: the port's progressive photon mapper over a scene of
sphere and triangle pools with specular surfaces (the cornell box), one
whole image per call.

The program's side: the port's `models.cornell.build` gives the scene,
the camera and the point light, and one `ppm.PPMRenderer` at
the traffic's sizes is kept for the run, as a process that renders many
images of one scene keeps it. An image is one `render()`: its iterations'
sum over the iteration count, the linear averaged image before gamma, as
float32 on the host; its count is the photon ray segments summed over its
iterations. The reference's side: the scene worked out again by
`reference.ppm_specular.scene` from the configuration file alone, rendered
by `reference.ppm_specular`. The scene is fixed: the seed changes nothing.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

__all__ = ["Inputs", "Entry"]


class Inputs:
    """A run's inputs and the reference's side: the image's size, the
    photon mapper's parameters, and the reference's image of the scene."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        if config["scene"] != "cornell":
            raise ValueError(f"entry ppm_pools: no scene {config['scene']!r}")
        self.config = config
        t = traffic
        self.size = (t["width"], t["height"])
        self.params = dict(iterations=t["iterations"],
                           photon_count=t["photon_count"],
                           alpha=config["ppm"]["alpha"],
                           max_bounces=t["max_bounces"])

    def reference(self, device, dtype=torch.float64, max_walk_steps=None):
        """The reference's (image, photon segments) of the scene.
        max_walk_steps bounds a mesh walk, which this scene has none of."""
        from ..reference import ppm_specular
        w, h = self.size
        sc, cam, lights = ppm_specular.scene(self.config, w / h)
        return ppm_specular.render(sc, cam, lights, w, h, device=device,
                                   dtype=dtype, **self.params)


class Entry:
    """One cell's program state: `image()` renders one image and returns
    (image (H, W, 3) float32 numpy, photon segments int). `build_s` is the
    host time of the set-up's scene build; `inputs` the run's Inputs."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from pathtracer_tpu_torch.models import cornell
        from pathtracer_tpu_torch.ppm import PPMRenderer
        self.inputs = Inputs(config, traffic, seed)
        w, h = self.inputs.size
        t0 = time.perf_counter()
        with record_function("port_bench.scene_build"):
            scene, cam, lights = cornell.build(w / h, device)
        self.build_s = time.perf_counter() - t0
        self.renderer = PPMRenderer(scene, cam, lights, w, h, verbose=False,
                                    **self.inputs.params)

    def image(self):
        r = self.renderer
        with record_function("port_bench.render"):
            img_sum = r.render()
        with record_function("port_bench.to_host"):
            host = (img_sum / r.iterations).to(torch.float32).cpu().numpy()
            segments = int(torch.stack([s for s, _ in r.iter_segments]).sum())
        return host, segments

    def sizes(self) -> dict:
        """The pools' real primitives, which the per-layer metrics' byte
        counts read: the configuration's spheres and its quads' triangles."""
        config = self.inputs.config
        return {"spheres": len(config["spheres"]),
                "triangles": 2 * len(config["quads"])}

    def release(self) -> None:
        """Drop the program's state."""
        self.renderer = None
