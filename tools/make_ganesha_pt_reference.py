"""Render the full-size path-traced ganesha reference with the JAX package on
the CPU.

    python tools/make_ganesha_pt_reference.py [-o scenes/ref_ganesha_pt_600x600_spp8_b8.npz]

The configuration is bench.py's `_run_ganesha_pt`, nothing cut: the
ganesha scene of `models/ganesha.py:build_pt` (scenes/big_ganesha.ply,
449,352 triangles, over the checkered floor, under the shirley sky) through
`integrator.make_render_fn(cam, background, 600, 600, 8, 8, mesh=mesh)`.
It writes an .npz with

  img          (600, 600, 3) float32: the rendered image (filtered and
               gamma-mapped, what make_render_fn returns);
  segments     the ray segments traced;
  width, height, spp, max_bounces;

On the CPU the JAX package traces in raster order with the XLA tier: the
BVH8 walk at every bounce (its tile-culled bounce-0 kernel is on only with
the TPU kernel tier), the XLA sphere and triangle tests. The PyTorch port
meets the primary rays with the tile-culled kernel and the rest with the
walk kernel. Both intersectors accept the same triangles with the same
rule (an exact tie in t aside: the walk keeps the first triangle it meets,
the tile kernel the lowest index). The two renderers round sin/cos and the
products of the hit tests differently in the last bit, so now and then a
path crosses a triangle's edge in one of them only and the pixel's sample
differs. chip_smoke.py holds the port's image to this file by the RMSE and
by the RMSE of 8x8-pixel means.

About 2.5 minutes on the CPU (the BVH build ~9 s).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from pathtracer_tpu.integrator import make_render_fn  # noqa: E402
from pathtracer_tpu.models import ganesha  # noqa: E402

WIDTH = HEIGHT = 600
SPP = 8
BOUNCES = 8
PLY = os.path.join(ROOT, "scenes", "big_ganesha.ply")
OUT = os.path.join(ROOT, "scenes", "ref_ganesha_pt_600x600_spp8_b8.npz")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-o", "--output", default=OUT)
    p.add_argument("--ply", default=PLY)
    args = p.parse_args()

    t0 = time.monotonic()
    scene, cam, bg, mesh = ganesha.build_pt(args.ply, WIDTH / HEIGHT)
    print(f"#triangles = {mesh.n_tris}, build {time.monotonic() - t0:.1f} s",
          flush=True)
    render = make_render_fn(cam, bg, WIDTH, HEIGHT, SPP, BOUNCES, mesh=mesh)
    t0 = time.monotonic()
    img, segs = render(scene)
    img = np.asarray(img, np.float32)
    segments = int(jax.device_get(segs))
    seconds = time.monotonic() - t0
    np.savez_compressed(args.output, img=img, segments=segments,
                        width=WIDTH, height=HEIGHT, spp=SPP,
                        max_bounces=BOUNCES)
    print(f"wrote {args.output}: {seconds:.1f} s, segments {segments}, "
          f"mean {float(img.mean()):.6f}, "
          f"rms {float(np.sqrt(np.mean(img.astype(np.float64) ** 2))):.6f}")


if __name__ == "__main__":
    main()
