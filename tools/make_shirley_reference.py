"""Render a float64 shirley-spheres reference of any seed and depth with the
JAX package on the CPU.

    python tools/make_shirley_reference.py --seed 7 --spp 32 --bounces 8 \
        -o scenes/oracle_shirley_seed7_600x300_spp32_f64.npz
    python tools/make_shirley_reference.py --seed 42 --spp 32 --bounces 16 \
        -o scenes/oracle_shirley_600x300_spp32_b16_f64.npz

The render is the reference README's command at 600x300:
`models/shirley.build(2.0, seed=N, dtype=float64, use_manifest=False)`
through `integrator.make_render_fn(..., dtype=float64)`, XLA on the CPU
with x64 on, as scenes/oracle_shirley_600x300_spp32_f64.npz was made
(tools/measure_rmse_spp32.py). The sphere list is the seed's own
(use_manifest=False: the JAX sphere_list returns the committed seed-42
manifest whenever it exists, whatever the seed); seed 42's own list is
the manifest's.

It writes an .npz with

  img          (300, 600, 3) float64: the rendered image (filtered and
               gamma-mapped, what make_render_fn returns);
  segments     the ray segments traced;
  seed, spp, max_bounces;
  spheres      the scene's sphere count (valid entries);
  seconds      the render's wall seconds on the CPU.

--check FILE compares the result with another reference file (its image
RMSE and max abs difference, and its segments where it has them).

At spp = 32 a render takes about 1.5 minutes at 8 bounces and 3.5 at 16
(the committed files store theirs: 91.3 s and 217.1 s).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
WIDTH, HEIGHT = 600, 300

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from pathtracer_tpu.integrator import make_render_fn  # noqa: E402
from pathtracer_tpu.models import shirley  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--spp", type=int, default=32)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--check", help="a reference .npz to compare with")
    args = p.parse_args()

    scene, cam, bg = shirley.build(WIDTH / HEIGHT, seed=args.seed,
                                   dtype=jnp.float64, use_manifest=False)
    n_spheres = int(np.asarray(scene.valid).sum())
    print(f"seed {args.seed}: #spheres = {n_spheres}", flush=True)
    render = make_render_fn(cam, bg, WIDTH, HEIGHT, args.spp, args.bounces,
                            dtype=jnp.float64)
    t0 = time.monotonic()
    img, segs = render(scene)
    img = np.asarray(img, np.float64)
    segments = int(jax.device_get(segs))
    seconds = time.monotonic() - t0
    np.savez_compressed(args.output, img=img, segments=segments,
                        seed=args.seed, spp=args.spp,
                        max_bounces=args.bounces, spheres=n_spheres,
                        seconds=seconds)
    print(f"wrote {args.output}: {seconds:.1f} s, segments {segments}, "
          f"mean {float(img.mean()):.6f}", flush=True)
    if args.check:
        ref = np.load(args.check)
        rmse = float(np.sqrt(np.mean((img - ref["img"]) ** 2)))
        max_abs = float(np.abs(img - ref["img"]).max())
        ref_segs = int(ref["segments"]) if "segments" in ref.files else None
        print(f"vs {args.check}: rmse {rmse:.6e}, max_abs {max_abs:.6e}, "
              f"segments {segments} vs {ref_segs}", flush=True)


if __name__ == "__main__":
    main()
