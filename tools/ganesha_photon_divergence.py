"""Count the ganesha photon deposits on which the PyTorch port and the JAX
package part ways, both on the CPU.

    python tools/ganesha_photon_divergence.py [--iteration 0]

Traces one iteration's photons (75,000, 4 bounces, the reference's default
ganesha configuration over scenes/big_ganesha.ply) with the JAX package
(XLA on the CPU) and with pathtracer_tpu_torch (the kernels' plain versions
on the CPU), and prints per bounce the valid deposits of each, the deposits
valid in one only, and the deposits valid in both whose positions differ by
more than 1e-4 and 1e-2 of their largest coordinate or by more than one
unit. The two packages round sin/cos and the Moller-Trumbore products
differently in the last bit; a deposit that differs by more than that
started a different path (an ulp moved a hit across a triangle edge).
About a minute (two BVH builds, one JAX compile).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pathtracer_tpu import ppm as jppm  # noqa: E402
from pathtracer_tpu.models import ganesha as jganesha  # noqa: E402
from pathtracer_tpu_torch import ppm  # noqa: E402
from pathtracer_tpu_torch.models import ganesha  # noqa: E402

PLY = os.path.join(ROOT, "scenes", "big_ganesha.ply")
PHOTONS, BOUNCES = 75_000, 4


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iteration", type=int, default=0)
    args = p.parse_args()
    offset = args.iteration * PHOTONS

    scene, _, lights, mesh, _ = jganesha.build(PLY, 1.0)
    trace, _, _ = jppm.make_photon_pass(scene, lights, PHOTONS, BOUNCES,
                                        "xla", mesh=mesh,
                                        devices=jax.devices())
    want = [np.asarray(x) for x in trace(jnp.uint32(offset))]

    scene, _, lights, mesh = ganesha.build(PLY, 1.0, torch.device("cpu"))
    trace, _, _ = ppm.make_photon_pass(scene, lights, PHOTONS, BOUNCES, mesh)
    got = [x.numpy() for x in trace(offset)[:4]]

    lanes = want[0].shape[0] // BOUNCES
    print(f"iteration {args.iteration}: photon map lengths "
          f"{int(want[3].sum())} (JAX) and {int(got[3].sum())} (port)")
    for b in range(BOUNCES):
        sl = slice(b * lanes, (b + 1) * lanes)
        ok_j, ok_p = want[3][sl], got[3][sl]
        both = ok_j & ok_p
        pj, pp = want[0][sl][both], got[0][sl][both]
        err = np.abs(pj - pp).max(axis=1)
        rel = err / np.abs(pj).max(axis=1)
        print(f"bounce {b}: valid {int(ok_j.sum())} / {int(ok_p.sum())}, "
              f"valid in one only {int((ok_j != ok_p).sum())}, position "
              f"off by > 1e-4 rel {int((rel > 1e-4).sum())}, > 1e-2 rel "
              f"{int((rel > 1e-2).sum())}, > 1 abs {int((err > 1).sum())}")


if __name__ == "__main__":
    main()
