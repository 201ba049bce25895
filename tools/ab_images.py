"""The benchmark cells' images in several checkouts of the repo, required
equal bit for bit.

    python3 tools/ab_images.py DIR [DIR ...] [--seed N] [--cells a,b,...]

Run from a checkout with a CUDA device. Each DIR is another checkout (the
parent commit's `git archive`, say, unpacked into a git-ignored directory
such as `_parent/`). Every checkout, this one first, renders each cell
(default: every workload of BENCHMARK.json) in a process of its own
through its own port_bench entry at the cell's full size, two images of
one scene from the seed (default 1): the first renders eagerly and
captures any CUDA graph, the second replays it with the kept renderer.
Prints a line a cell with every checkout's segments, and exits 1 unless
each image and segment count equals this checkout's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

TREE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(TREE, "pathtracer_tpu_torch", "_build", "ab_images")

# one checkout's renders: cells, seed and output directory from argv
CHILD = """
import importlib, os, sys
import numpy as np, torch
from port_bench import spec
cells, seed, out = sys.argv[1].split(","), int(sys.argv[2]), sys.argv[3]
for name in cells:
    c = spec.cell(name)
    t = c["traffic_spec"]
    entry = importlib.import_module("port_bench.entries." + t["entry"]).Entry(
        c["config_spec"], t, seed, torch.device("cuda"))
    (a, sa), (b, sb) = entry.image(), entry.image()
    entry.release()
    np.savez(os.path.join(out, name + ".npz"), images=np.stack([a, b]),
             segments=np.array([sa, sb]))
"""


def render(tree: str, tag: str, cells, seed: int) -> dict:
    out = os.path.join(OUT, tag)
    os.makedirs(out, exist_ok=True)
    subprocess.run([sys.executable, "-c", CHILD, ",".join(cells), str(seed),
                    out], cwd=tree, check=True)
    return {c: np.load(os.path.join(out, c + ".npz")) for c in cells}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cells", default=None)
    args = ap.parse_args(argv)
    with open(os.path.join(TREE, "BENCHMARK.json")) as f:
        every = [w["name"] for w in json.load(f)["workloads"]]
    cells = args.cells.split(",") if args.cells else every
    trees = [TREE] + [os.path.abspath(d) for d in args.dirs]
    got = [render(t, f"{i}_{os.path.basename(t)}", cells, args.seed)
           for i, t in enumerate(trees)]
    ok = True
    for c in cells:
        mine = got[0][c]
        same = [np.array_equal(g[c]["images"].view(np.uint32),
                               mine["images"].view(np.uint32))
                and np.array_equal(g[c]["segments"], mine["segments"])
                for g in got[1:]]
        ok &= all(same)
        print(json.dumps({"cell": c, "seed": args.seed, "equal": same,
                          "segments": [g[c]["segments"].tolist()
                                       for g in got]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"ok": ok, "device": smi}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
