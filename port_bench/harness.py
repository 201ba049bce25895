"""One run of a cell: set-up, a closed loop of whole images for a fixed
window, the comparison with the reference, and the result line.

The loop asks for one image at a time and asks for the next when it is on
the host, until the window's seconds have passed; the image under way then
finishes and counts. image_s is the window (its start to the last image's
end) over the images finished in it; image_p95_s is the 95th percentile
(nearest rank) of every image's own time, from its render call to its
image on the host. setup_s runs from the process's start to the first
timed image: imports, the CUDA context, the kernel libraries (built on a
checkout's first run), the scene build and the warm-up images.

With trace on, the first `trace_images` images of the window run under a
profiler of the card alone (the device group), the next `gap_images` under
one of the host too, in the host span profiling.WINDOW (the gap group),
and the rest of the window untraced. The per-layer metrics read the device
group's trace and the untraced images' image_s; the gap group only names
the breakdown's idle gaps. Only the per-layer metrics are reported then.

Once the window has closed and the device's peak memory has been read,
the program's state is dropped and the reference renders the run's
scene once; every image of the window is compared with it, and each
compared number (the worst over the images) is printed beside its limit.
"""

from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import torch
from torch.profiler import record_function

from . import compare, isolation, profiling, spec

__all__ = ["window_stats", "run_cell", "main"]


def window_stats(starts, ends) -> dict:
    """image_s and image_p95_s of a window of images timed from `starts`
    to `ends` (host seconds, in order; the window opens at starts[0])."""
    n = len(ends)
    times = sorted(e - s for s, e in zip(starts, ends))
    p95 = times[max(0, math.ceil(0.95 * n) - 1)]
    return {"image_s": (ends[-1] - starts[0]) / n, "image_p95_s": p95}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Run cell `cell` (spec.cell's dict) and return the result line as a
    dict, with `checks` (each number and its limit) last."""
    traffic = cell["traffic_spec"]
    entry = importlib.import_module(f"port_bench.entries.{traffic['entry']}"
                                    ).Entry(cell["config_spec"], traffic,
                                            seed, device)
    for _ in range(int(traffic.get("warmup_images", 1))):
        entry.image()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    n_dev = int(traffic.get("trace_images", 1)) if trace else 0
    n_gap = int(traffic.get("gap_images", 1)) if trace else 0
    dev = gap = scope = None
    if n_dev:  # the profiler's first start takes a second or more
        dev = profiling.start(host=False)
    images, segments, starts, ends = [], [], [], []
    t0 = dev_t0 = time.perf_counter()
    while not ends or ends[-1] - t0 < seconds:
        i = len(ends)
        if i == n_dev and n_gap:
            gap = profiling.start(host=True)
            scope = record_function(profiling.WINDOW)
            scope.__enter__()
        starts.append(time.perf_counter())
        img, segs = entry.image()
        ends.append(time.perf_counter())
        images.append(img)
        segments.append(segs)
        if i + 1 == n_dev:
            _sync(device)
            dev_s = time.perf_counter() - dev_t0
            dev.stop()
        if i + 1 == n_dev + n_gap and scope is not None:
            scope.__exit__(None, None, None)
            _sync(device)
            gap.stop()
            scope = None
    n = len(ends)
    if dev is not None and n < n_dev:  # a window shorter than the groups
        _sync(device)
        dev_s = time.perf_counter() - dev_t0
        dev.stop()
    if scope is not None:
        scope.__exit__(None, None, None)
        gap.stop()
    n_traced = min(n_dev, n)
    k0 = n_dev + n_gap  # the first image that ran untraced
    rest = window_stats(starts[k0:], ends[k0:]) if trace and n > k0 \
        else None
    if dev is not None:
        print(f"port_bench: {n_traced} images traced (the card alone) in "
              f"{dev_s!r} s; {n - k0} untraced, image_s "
              f"{rest['image_s'] if rest else None!r}", file=sys.stderr)

    memory = (torch.cuda.max_memory_allocated()
              if torch.device(device).type == "cuda" else 0)
    profile = profiling.read_device(dev, dev_s) if dev is not None else None
    if profile is not None and gap is not None:
        profile.gaps = profiling.read_gaps(gap) or []
    ctx = SimpleNamespace(
        profile=profile, traced_images=n_traced,
        traced_segments=sum(segments[:n_traced]),
        untraced_image_s=rest["image_s"] if rest else None,
        traffic=traffic, sizes=entry.sizes(), build_s=entry.build_s)
    inputs = entry.inputs
    entry.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    ref = inputs.reference(device)
    per_image = [compare.image_numbers(img, segs, *ref)
                 for img, segs in zip(images, segments)]
    worst, failed = compare.judge(per_image, cell["limits"])

    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            value = spec.load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        stats = window_stats(starts, ends)
        stats["setup_s"] = setup_s
        metrics = {m["name"]: {"value": stats[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    out = {"correct": failed == 0, "attempted": len(images),
           "failed": failed, "metrics": metrics,
           "device": _device(device, cell["chips"], memory)}
    if trace and profile is not None:
        out["device"]["busy_s"] = profile.busy_s
        out["device"]["window_s"] = profile.window_s
        out["breakdown"] = profile.breakdown()
    out["checks"] = {k: {"value": worst[k], "limit": cell["limits"][k]}
                     for k in compare.NUMBERS}
    return out


def _device(device, chips: int, memory: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": memory}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": memory,
            "power_limit": _power_limit()}


def _power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() \
        else "not read"


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="one run of a port_bench cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device; this benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start)
    bad = isolation.forbidden_loaded()
    if bad:
        print(f"port_bench: the run loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"card: {out['device']['kind']}, power limit "
          f"{out['device']['power_limit']}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
