"""Finds what a cell is made of, by name: its entry in BENCHMARK.json, its
configuration file, its traffic file, its limits and its metrics.

- `BENCHMARK.json` (the repository's root) lists the cells, each naming a
  configuration and a traffic mix, and the metrics with the cells that
  report them.
- `configs/<config>.json`: the scene as it is run (its source, camera,
  sky, materials and sizes, what was cut and what was assumed); the
  reference works the scene out from it.
- `traffic/<traffic>.json`: the images asked for, read by one general
  loop: `entry` (the module `entries/<entry>.py` that drives the program),
  the image's `width`, `height`, `spp` and `max_bounces`, the warm-up
  images, and the images a traced run profiles: `trace_images` of the card
  alone, then `gap_images` with the host's operators too.
- `limits/<cell>.json`: the limit of each number the comparison gives.
- `metrics/<metric>.py`: a per-layer metric's reader, `read(ctx)`.

A cell, a configuration or a metric is added as files of its own and an
entry in BENCHMARK.json; no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

__all__ = ["ROOT", "HERE", "benchmark", "cell", "load_metric"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell(name: str, bench: dict | None = None, here: str = HERE) -> dict:
    """Everything a run of cell `name` needs, as one dict: the BENCHMARK.json
    entry's keys, `config_spec`, `traffic_spec`, `limits`, and the
    `end_to_end` and `per_layer` metrics that the cell reports."""
    bench = benchmark() if bench is None else bench
    rows = [w for w in bench["workloads"] if w["name"] == name]
    if not rows:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    out = dict(rows[0])
    out["config_spec"] = _json(os.path.join(here, "configs",
                                            f"{out['config']}.json"))
    out["traffic_spec"] = _json(os.path.join(here, "traffic",
                                             f"{out['traffic']}.json"))
    out["limits"] = _json(os.path.join(here, "limits", f"{name}.json"))
    out["end_to_end"] = [m for m in bench["end_to_end"] if _reports(m, name)]
    out["per_layer"] = [m for m in bench["per_layer"] if _reports(m, name)]
    return out


def load_metric(name: str, here: str = HERE):
    """The reader module `metrics/<name>.py`, loaded from its path (a
    metric's name may hold dots)."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
