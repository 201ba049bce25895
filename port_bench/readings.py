"""The readings the comparison's limits are set from, on the card at a
cell's own sizes, printed as one JSON line each.

    python3 -m port_bench.readings --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9

- For each of `--seeds`: the program's images of the cell (after one
  warm-up image), through the same entry and comparison as a run, against
  the float64 reference: the lower readings.
- For each of `--control-seeds`: the control, the reference computed in
  the precision below the configuration's `precision` (bfloat16 for
  float32: the path tracer runs no tensor-core work), against the float64
  reference: the upper readings.

Each line holds the seed, the numbers of each compared image and the
reference's seconds. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from . import compare, spec

CONTROL_WALK_STEPS = 20000
# the precision a configuration states -> its control's, the next below
CONTROL = {"float32": torch.bfloat16}


def _entry_module(cell: dict):
    return importlib.import_module(
        f"port_bench.entries.{cell['traffic_spec']['entry']}")


def _images(cell: dict, seed: int):
    entry = _entry_module(cell).Entry(cell["config_spec"],
                                      cell["traffic_spec"], seed, "cuda")
    entry.image()
    shot = entry.image()
    entry.release()
    torch.cuda.empty_cache()
    return entry, shot


def lower(cell: dict, seed: int) -> dict:
    entry, (img, segs) = _images(cell, seed)
    t0 = time.perf_counter()
    ref = entry.inputs.reference("cuda")
    return {"seed": seed, "kind": "program",
            "numbers": [compare.image_numbers(img, segs, *ref)],
            "reference_s": time.perf_counter() - t0}


def upper(cell: dict, seed: int) -> dict:
    inputs = _entry_module(cell).Inputs(cell["config_spec"],
                                        cell["traffic_spec"], seed)
    dtype = CONTROL[cell["config_spec"]["precision"]]
    t0 = time.perf_counter()
    ref = inputs.reference("cuda")
    t1 = time.perf_counter()
    ctl = inputs.reference("cuda", dtype, max_walk_steps=CONTROL_WALK_STEPS)
    t2 = time.perf_counter()
    return {"seed": seed, "kind": f"control_{str(dtype).split('.')[-1]}",
            "numbers": [compare.image_numbers(ctl[0], ctl[1], *ref)],
            "reference_s": t1 - t0, "control_s": t2 - t1}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    for seed in seeds(args.seeds):
        print(json.dumps(dict(lower(cell, seed), workload=args.workload)),
              flush=True)
    for seed in seeds(args.control_seeds):
        print(json.dumps(dict(upper(cell, seed), workload=args.workload)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
