"""Render the full-size cornell-box reference with the JAX package on the CPU.

    python tools/make_cornell_reference.py [-o scenes/ref_cornell_600x600_it10_pc75k_b4.npz]

The configuration is the reference's default cornell-box command, nothing
cut: 600x600, 10 iterations, 75,000 photons per iteration, 4 bounces. It
runs `ppm.PPMRenderer` on XLA-CPU (the XLA intersectors and the hash-grid
gather) and writes an .npz with

  img                 (600, 600, 3) float32: the averaged linear image, the
                      sum of the iterations' images over their count, rows
                      in output order (before the 1/2.2 gamma);
  photon_map_lengths  (10,) int64: the valid deposits of each iteration;
  width, height, iterations, photon_count, max_bounces, alpha.

A few minutes on the CPU (one iteration is some 12 s there).
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

from pathtracer_tpu.models import cornell  # noqa: E402
from pathtracer_tpu.ppm import PPMRenderer  # noqa: E402

WIDTH = HEIGHT = 600
ITERATIONS = 10
PHOTONS = 75_000
BOUNCES = 4
OUT = os.path.join(ROOT, "scenes", "ref_cornell_600x600_it10_pc75k_b4.npz")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-o", "--output", default=OUT)
    args = p.parse_args()

    scene, cam, lights = cornell.build(WIDTH / HEIGHT)
    lengths = []

    def phase_cb(name, value):
        if name == "photon_trace":
            lengths.append(int(np.asarray(value[3]).sum()))

    rend = PPMRenderer(scene, cam, lights, WIDTH, HEIGHT,
                       iterations=ITERATIONS, photon_count=PHOTONS,
                       max_bounces=BOUNCES, verbose=True, phase_cb=phase_cb)
    t0 = time.monotonic()
    img_sum = rend.render()
    seconds = time.monotonic() - t0
    assert len(lengths) == ITERATIONS, lengths
    img = (np.asarray(img_sum, np.float64) / ITERATIONS).astype(np.float32)
    np.savez_compressed(
        args.output, img=img, photon_map_lengths=np.asarray(lengths, np.int64),
        width=WIDTH, height=HEIGHT, iterations=ITERATIONS,
        photon_count=PHOTONS, max_bounces=BOUNCES, alpha=rend.alpha)
    print(f"wrote {args.output}: {seconds:.1f} s, photon map lengths "
          f"{lengths}, mean {float(img.mean()):.6f}")


if __name__ == "__main__":
    main()
