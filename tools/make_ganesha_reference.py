"""Render the full-size ganesha reference with the JAX package on the CPU.

    python tools/make_ganesha_reference.py [-o scenes/ref_ganesha_600x600_it10_pc75k_b4.npz]
        [--witness scenes/ref_ganesha_600x600_it1_photons.npz]

The configuration is the reference's default ganesha command, nothing cut:
`ganesha -width 600 -height 600 -iterations 10 -photon-count 75000
-max-bounces 4` over scenes/big_ganesha.ply (449,352 triangles, the
synthetic stand-in shell). It runs `ppm.PPMRenderer` on XLA-CPU and writes
an .npz with

  img                 (600, 600, 3) float32: the averaged linear image, the
                      sum of the iterations' images over their count, rows
                      in output order (before the 1/2.2 gamma);
  photon_map_lengths  (10,) int64: the valid deposits of each iteration;
  width, height, iterations, photon_count, max_bounces, alpha;

and a second .npz (--witness) with the first iteration alone:

  pos, nrm, flux      (N, 3) float32: the iteration's valid photon deposits,
                      in the photon pass's order;
  img                 (600, 600, 3) float32: that iteration's image over
                      those deposits, rows in output order;
  radius              the gather radius r(1).

The second file lets the port's eye pass (eye rays, gather, film) be held
to the JAX one over the same photons, apart from the photon paths.

On the CPU the JAX renderer intersects the eye rays with the BVH8 walk
(its tile-culled kernel is on only with the TPU kernel tier) and gathers
photons through the XLA hash grid. The PyTorch port on the card intersects
the eye rays with the tile-culled triangle kernel and gathers through the
chunk-gather kernel. Both intersectors accept the same triangles with the
same rule (an exact tie in t aside: the walk keeps the first triangle it
meets, the tile kernel the lowest index) and both gathers sum the same
photons. The images still differ in single pixels: the two renderers round
sin/cos and the products of the hit tests differently in the last bit, an
ulp now and then moves a photon's hit across one of the mesh's triangle
edges and sends it elsewhere (tools/ganesha_photon_divergence.py counts
them), and the gather radius is under a pixel, so such a photon changes
one pixel by up to its whole value. chip_smoke.py holds the port's image
to this file by the RMSE and by the RMSE of 8x8-pixel means.

About 1.5 minutes on the CPU (the BVH build ~9 s, one iteration ~8 s warm).
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

from pathtracer_tpu.models import ganesha  # noqa: E402
from pathtracer_tpu.ppm import PPMRenderer  # noqa: E402

WIDTH = HEIGHT = 600
ITERATIONS = 10
PHOTONS = 75_000
BOUNCES = 4
PLY = os.path.join(ROOT, "scenes", "big_ganesha.ply")
OUT = os.path.join(ROOT, "scenes", "ref_ganesha_600x600_it10_pc75k_b4.npz")
WITNESS = os.path.join(ROOT, "scenes", "ref_ganesha_600x600_it1_photons.npz")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-o", "--output", default=OUT)
    p.add_argument("--witness", default=WITNESS)
    p.add_argument("--ply", default=PLY)
    args = p.parse_args()

    t0 = time.monotonic()
    scene, cam, lights, mesh, bbox = ganesha.build(args.ply, WIDTH / HEIGHT)
    print(f"#triangles = {mesh.n_tris}, build {time.monotonic() - t0:.1f} s",
          flush=True)
    lengths, first = [], {}

    def phase_cb(name, value):
        if name == "photon_trace":
            pos, nrm, flux, ok = (np.asarray(x) for x in value)
            lengths.append(int(ok.sum()))
            if not first:
                first.update(pos=pos[ok], nrm=nrm[ok], flux=flux[ok])

    def checkpoint_cb(i, img_sum):
        if i == 0:
            first["img"] = np.asarray(img_sum, np.float32)

    rend = PPMRenderer(scene, cam, lights, WIDTH, HEIGHT,
                       iterations=ITERATIONS, photon_count=PHOTONS,
                       max_bounces=BOUNCES, verbose=True, mesh=mesh,
                       bbox_override=bbox, phase_cb=phase_cb)
    t0 = time.monotonic()
    img_sum = rend.render(checkpoint_cb=checkpoint_cb)
    seconds = time.monotonic() - t0
    assert len(lengths) == ITERATIONS, lengths
    img = (np.asarray(img_sum, np.float64) / ITERATIONS).astype(np.float32)
    np.savez_compressed(
        args.output, img=img, photon_map_lengths=np.asarray(lengths, np.int64),
        width=WIDTH, height=HEIGHT, iterations=ITERATIONS,
        photon_count=PHOTONS, max_bounces=BOUNCES, alpha=rend.alpha)
    print(f"wrote {args.output}: {seconds:.1f} s, photon map lengths "
          f"{lengths}, mean {float(img.mean()):.6f}, "
          f"rms {float(np.sqrt(np.mean(img.astype(np.float64) ** 2))):.6f}")
    np.savez_compressed(args.witness, radius=rend.radius(1), **first)
    print(f"wrote {args.witness}: {len(first['pos'])} deposits, r(1) "
          f"{rend.radius(1):.6f}")


if __name__ == "__main__":
    main()
