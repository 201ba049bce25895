"""The BVH4 walk's device time in several checkouts of the repo, on the
same rays, in turns.

    python3 tools/ab_bvh4_walk.py DIR [DIR ...]

Run from a checkout with a CUDA device. Each DIR is another checkout (the
parent commit's `git archive`, say, unpacked into a git-ignored directory
such as `_parent/`); its own package, csrc/bvh4_walk.cu included, is built
and timed through its own `bvh4_walk` wrapper, in a process of its own.

The rays are phase 15's of chip_smoke.py (`bvh4_ray_sets`): big_ganesha on
the BVH4 table, the photon pass's bounces 0 and 1 and the path-traced
pass's bounces 1 and 3, and big_ganesha subdivided 4:1 (past the BVH8
table's range), the path-traced bounces 1 and 3; beside each path-traced
bounce-1 set three orders of it by the plain walk's steps per lane: the
LONGEST longest rays packed eight to a warp, the same rays one to a warp,
and every ray longest first. This checkout records them once, with its
kernel's outputs (held equal to the plain walk's), its counters (held
equal to the active lanes and the plain emulation's table loads) and the
emulation's steps, under pathtracer_tpu_torch/_build/ (RAYS). Then each
checkout, this one first, times the sets in the order given and again in
reverse, and must give the recorded outputs bit for bit; a checkout whose
wrapper takes the walk's counters (`counts`) is timed with them on, and
must count as recorded.
Prints a line a set with every checkout's device ms (chip_smoke.held_ms)
and CUDA-event ms (chip_smoke.time_ms), medians and each turn, then
nvidia-smi's name and power limit.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys

TREE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAYS = os.path.join(TREE, "pathtracer_tpu_torch", "_build", "ab_bvh4.pt")
LONGEST = 2048  # rays of the two longest-ray orders


def smoke():
    """This checkout's chip_smoke.py as a module (no package import)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(TREE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas(build) -> str:
    """ptxas's report on bvh4_walk_kernel from the package's build log
    (empty where the library was built before this process)."""
    log = build.build_log.splitlines()
    return json.dumps([" ".join(x.split(":", 1)[-1].strip()
                                for x in log[i + 1:i + 4])
                       for i, ln in enumerate(log)
                       if "Compiling entry" in ln and "bvh4_walk" in ln])


def orders(torch, rays, steps) -> dict:
    """The three orders of one ray set (org, d, t_max0, active) by the
    plain walk's steps per lane."""
    order = torch.argsort(steps, descending=True, stable=True)
    longest = order[:LONGEST]
    n, dev = LONGEST * 8, steps.device
    spread = [torch.zeros(n, 3, device=dev), torch.ones(n, 3, device=dev),
              torch.full((n,), 1e30, device=dev),
              torch.zeros(n, dtype=torch.bool, device=dev)]
    at = torch.arange(LONGEST, device=dev) * 8
    for x, y in zip(spread, rays):
        x[at] = y[longest]
    return {"longest": tuple(x[longest] for x in rays),
            "longest_one_per_warp": tuple(spread),
            "longest_first": tuple(x[order] for x in rays)}


def record() -> None:
    """Write RAYS: the tables, every set's rays, this checkout's kernel
    outputs on them and the plain walk's and the emulation's counts."""
    import functools
    from unittest import mock

    import numpy as np
    import torch

    cs = smoke()
    sys.path.insert(0, TREE)
    from pathtracer_tpu_torch import _build
    from pathtracer_tpu_torch.models import ganesha
    from pathtracer_tpu_torch.ops.bvh import MeshBVH
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw

    dev = torch.device("cuda", 0)
    _build.load()
    print(f"[ab_bvh4_build] variant=tree ptxas={ptxas(_build)}", flush=True)
    with mock.patch.object(ganesha, "MeshBVH",
                           functools.partial(MeshBVH, walk="bvh4")):
        scene, cam, lights, mesh = ganesha.build(cs.GANESHA_PLY, 1.0, dev)
    sets = {name: (mesh, rays) for name, rays in
            cs.bvh4_ray_sets(mesh, scene, cam, lights, dev).items()}
    sub_ply, _, _ = cs.bvh4_sub4_ply(np)
    scene_b, cam_b, _, mesh_b = ganesha.build_pt(sub_ply, 1.0, dev)
    os.remove(sub_ply)
    sets.update({f"sub4_{name}": (mesh_b, rays) for name, rays in
                 cs.bvh4_ray_sets(mesh_b, scene_b, cam_b, None, dev,
                                  photons=False).items()})
    for name in [n for n in sets if n.endswith("pt_b1")]:
        m, rays = sets[name]
        steps = bw.bvh4_walk_plain(m.table, *rays, m.node_end, m.stride,
                                   count_steps=True)[5].sum(1)
        sets.update({f"{name}_{label}": (m, sub) for label, sub in
                     orders(torch, rays, steps).items()})
    meshes = {"ganesha": mesh, "sub4": mesh_b}
    out = {"tables": {k: m.table.cpu() for k, m in meshes.items()},
           "sets": {}}
    for name, (m, rays) in sets.items():
        args = (m.table, *rays, m.node_end, m.stride)
        want, fields, w_bound = cs.walk_work(torch, bw, args, walk="bvh4")
        walked = torch.zeros(2, dtype=torch.int64, device=dev)
        got = bw.bvh4_walk(*args, walked)
        cs.require(all(torch.equal(g, w) for g, w in zip(got, want)),
                   f"{name}: bvh4_walk differs from its plain version")
        counts = cs.cache_counts(torch, bw, args, want)
        walked = walked.tolist()
        cs.require(walked == [int(rays[3].sum()), counts["loads"]],
                   f"{name}: bvh4_walk counted {walked}, want the active "
                   f"lanes and the emulation's {counts['loads']} loads")
        out["sets"][name] = dict(
            table="ganesha" if m is mesh else "sub4",
            rays=[x.cpu() for x in rays], node_end=m.node_end,
            stride=m.stride, want=[x.cpu() for x in want], walked=walked,
            info=dict(lanes=rays[0].shape[0],
                      steps_mean=fields["steps_mean"],
                      steps_max=fields["steps_max"],
                      bound_ms=f"{w_bound['bound_ms']:.4f}",
                      **{k: counts[k] for k in ("loads_mean", "loads_max",
                                                "served_from_cache")}))
    torch.save(out, RAYS)
    with open(RAYS + ".json", "w") as f:
        json.dump({k: v["info"] for k, v in out["sets"].items()}, f)


def time_sets(root: str) -> None:
    """Time `bvh4_walk` of the package under root on every set of RAYS;
    prints {set: [device ms, event ms]} as JSON on the last line."""
    import torch

    cs = smoke()
    sys.path.insert(0, root)
    from pathtracer_tpu_torch import _build
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw

    dev = torch.device("cuda", 0)
    _build.load()
    print(ptxas(_build))
    rec = torch.load(RAYS, weights_only=True)
    tables = {k: t.to(dev) for k, t in rec["tables"].items()}
    # a wrapper with the walk's counters takes them on, as MeshBVH does
    counted = "counts" in inspect.signature(bw.bvh4_walk).parameters
    extra = ((torch.zeros(2, dtype=torch.int64, device=dev),) if counted
             else ())
    res = {}
    for name, s in rec["sets"].items():
        args = (tables[s["table"]], *(x.to(dev) for x in s["rays"]),
                s["node_end"], s["stride"], *extra)
        if counted:
            extra[0].zero_()
        got = bw.bvh4_walk(*args)
        torch.cuda.synchronize()
        cs.require(all(torch.equal(g.cpu(), w) for g, w in
                       zip(got, s["want"])),
                   f"{root}: bvh4_walk differs on {name}")
        if counted:
            cs.require(extra[0].tolist() == s["walked"],
                       f"{root}: bvh4_walk counted {extra[0].tolist()} on "
                       f"{name}, want {s['walked']}")
        res[name] = [cs.held_ms(torch, lambda: bw.bvh4_walk(*args)),
                     cs.time_ms(torch, lambda: bw.bvh4_walk(*args))]
    print(json.dumps(res))


def main(dirs) -> None:
    cs = smoke()
    cs.require(not subprocess.run([sys.executable, __file__, "--record"],
                                  cwd=TREE).returncode, "recording failed")
    labels = {"tree": TREE, **{os.path.basename(os.path.normpath(p)):
                               os.path.abspath(p) for p in dirs}}
    turns = {label: [] for label in labels}
    for label in list(labels) + list(labels)[::-1]:
        res = subprocess.run([sys.executable, __file__, "--time",
                              labels[label]], cwd=TREE, capture_output=True,
                             text=True)
        cs.require(res.returncode == 0, f"{label}:\n{res.stdout}{res.stderr}")
        lines = res.stdout.splitlines()
        print(f"[ab_bvh4_build] variant={label} ptxas={lines[0]}", flush=True)
        turns[label].append(json.loads(lines[-1]))
    with open(RAYS + ".json") as f:
        info = json.load(f)
    smi = cs.nvidia_smi()
    for name, fields in info.items():
        by = {label: [t[name] for t in ts] for label, ts in turns.items()}
        cs.phase("ab_bvh4", set=name, **fields, device_ms=json.dumps(
            {k: round(statistics.median(x[0] for x in v), 4)
             for k, v in by.items()}),
            device_ms_turns=json.dumps({k: [round(x[0], 4) for x in v]
                                        for k, v in by.items()}),
            event_ms=json.dumps({k: round(statistics.median(x[1] for x in v),
                                          4) for k, v in by.items()}))
    print(smi)


if __name__ == "__main__":
    if sys.argv[1:] == ["--record"]:
        record()
    elif sys.argv[1:2] == ["--time"] and len(sys.argv) == 3:
        time_sets(sys.argv[2])
    elif len(sys.argv) >= 2:
        main(sys.argv[1:])
    else:
        sys.exit(__doc__)
