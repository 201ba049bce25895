#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pathtracer_tpu_torch) on one NVIDIA
GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:
  1. device: the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
  2. build: nvcc builds csrc/*.cu for sm_90a (timed);
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, which it must equal exactly, at the shapes of the canonical render (600x300 in 32x32 tiles:
     190 tiles, 194,560 rays), with times (median of 7 after a warm-up,
     CUDA events);
  4. main path: `shirley-spheres 600x300 spp=32 b=8` through make_render_fn
     (what the CLI calls), with the kernels' launch counts, the segment
     count and the RMSE against the committed float64 oracle, the median
     wall time of 5 warm renders, and one profiled render's device time by
     kernel and idle share of its own wall (full table in
     chiprun_out/render_profile.txt);
  5. CLI: `python -m pathtracer_tpu_torch shirley-spheres ...` writes a
     600x300 PNG (to chiprun_out/).
Then a JSON line of kernel results, the nvidia-smi line, and the final
`{"ok": true, "device": {...}}` line. Without a CUDA device, or without the
package beside this script, it fails before printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import struct
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out")

# canonical render (the reference README's command)
WIDTH, HEIGHT, SPP, BOUNCES = 600, 300, 32, 8
ORACLE = os.path.join(ROOT, "scenes", "oracle_shirley_600x300_spp32_f64.npz")
ORACLE_SEGMENTS = 14_431_692  # the float64 oracle run's segment count
SEGMENT_SLACK = 3_000
RMSE_BUDGET = 1e-3
# Kernel vs plain on the card: none. The kernels are built without FMA
# contraction and fast math and round every operation as the plain versions
# do, so state, radiance and alive flags must be equal. (The 1e-2 / 1e-6
# tolerances of tests/test_torch_fused_bounce.py are for the port against
# XLA, which contracts FMAs.)


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 7, batch: int = 10) -> float:
    """Median over `reps` of the CUDA-event time of `batch` back-to-back
    calls, per call, in ms, after one warm-up. Includes the wrapper's host
    time wherever the host, not the device, is the slower of the two."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def device_times(torch, fn, reps: int = 10):
    """Profile `reps` calls of fn (torch.profiler, CUPTI). Returns (total
    device ms per call, {kernel name: device ms per call}, device operations
    per call, wall ms per call of the profiled calls). Only the device's own
    events (kernels, copies, fills) count: a CPU operator's device time is
    that of the kernels it launched, which are listed too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    per = {}
    n_ops = 0
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)):
            per[e.key] = per.get(e.key, 0.0) + (e.self_device_time_total
                                                / reps / 1e3)
            n_ops += e.count
    return sum(per.values()), per, n_ops / reps, wall_ms


def kernel_ms(per: dict, name: str) -> float:
    return sum(ms for key, ms in per.items() if name in key)


def png_size(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        head = f.read(24)
    require(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR",
            f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def main() -> None:
    import numpy as np
    import torch

    # --- 1. device -------------------------------------------------------
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    import pathtracer_tpu_torch
    require(os.path.dirname(os.path.abspath(pathtracer_tpu_torch.__file__))
            == os.path.join(ROOT, "pathtracer_tpu_torch"),
            "pathtracer_tpu_torch is not the package beside this script")
    from pathtracer_tpu_torch import _build
    from pathtracer_tpu_torch.integrator import Renderer, make_render_fn
    from pathtracer_tpu_torch.models import shirley
    from pathtracer_tpu_torch.ops.cuda import compact_kernel as ck
    from pathtracer_tpu_torch.ops.cuda import fused_bounce_kernel as fbk

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    phase("device", gpu=json.dumps(smi), torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=json.dumps(nvcc),
          count=torch.cuda.device_count())

    # --- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    regs = [ln.split(":", 1)[1].strip() for ln in _build.build_log.splitlines()
            if "registers" in ln]
    phase("build", seconds=f"{time.perf_counter() - t0:.3f}",
          arch="sm_90a", library=os.path.basename(_build.library_path()),
          ptxas=json.dumps(regs))

    # --- 3. kernels vs their plain versions, at the canonical shapes -----
    scene, cam, bg = shirley.build(WIDTH / HEIGHT, dev)
    r = Renderer(scene, cam, bg, WIDTH, HEIGHT, SPP, BOUNCES, dev)
    bg_mode, colors = bg
    state0, off = r.initial_wavefront(0)
    rad0 = torch.zeros(3, state0.shape[1], 128, device=dev)
    require(state0.shape == (10, 1520, 128), f"wavefront {state0.shape}")
    lists = (r.lists, r.counts)

    def bounce(fn, state, b, listed):
        return fn(r.sph_table, state, r.pack_table, off,
                  r.sampler.limbs(2 + 2 * b, 3 + 2 * b), colors, rad0,
                  bg_mode=bg_mode, origin_zero=(b == 0),
                  block_lists=lists if listed else None)

    fb_err = 0.0
    fb_times = {}
    state_in = state0
    for b, listed in ((0, True), (1, False), (2, False)):
        st_k, rad_k = bounce(fbk.fused_bounce, state_in, b, listed)
        st_p, rad_p = bounce(fbk.fused_bounce_plain, state_in, b, listed)
        torch.cuda.synchronize()
        n_diff = int(((st_k[9] > 0) != (st_p[9] > 0)).sum())
        d_state = float((st_k - st_p).abs().max())
        d_rad = float((rad_k - rad_p).abs().max())
        exact = torch.equal(st_k, st_p) and torch.equal(rad_k, rad_p)
        live = int((st_k[9] > 0).sum())
        kms = time_ms(torch, lambda: bounce(fbk.fused_bounce, state_in, b,
                                            listed))
        pms = time_ms(torch, lambda: bounce(fbk.fused_bounce_plain, state_in,
                                            b, listed))
        fb_times[b] = (kms, pms)
        _, per, _, _ = device_times(
            torch, lambda: bounce(fbk.fused_bounce, state_in, b, listed))
        pdev, _, _, _ = device_times(
            torch, lambda: bounce(fbk.fused_bounce_plain, state_in, b, listed))
        phase("fused_bounce", bounce=b, variant="listed" if listed else "full",
              live_in=int((state_in[9] > 0).sum()), live_out=live,
              alive_diff=n_diff, max_abs_state=d_state, max_abs_rad=d_rad,
              equal=exact, ms=f"{kms:.4f}", plain_ms=f"{pms:.4f}",
              device_ms=f"{kernel_ms(per, 'fused_bounce_kernel'):.4f}",
              plain_device_ms=f"{pdev:.4f}")
        require(exact, f"bounce {b}: the kernel differs from its plain "
                f"version ({n_diff} alive flags, state {d_state}, "
                f"radiance {d_rad})")
        fb_err = max(fb_err, d_state, d_rad)
        state_in = st_k

    # compaction at bounce 3, on the wavefront the render compacts
    ck_k = ck.compact_blocks(state_in, off)
    ck_p = ck.compact_blocks_plain(state_in, off)
    torch.cuda.synchronize()
    exact = (torch.equal(ck_k[0].view(torch.int32), ck_p[0].view(torch.int32))
             and torch.equal(ck_k[1], ck_p[1]) and torch.equal(ck_k[2],
                                                               ck_p[2]))
    ck_err = max(float((ck_k[0] - ck_p[0]).abs().max()),
                 float((ck_k[1] - ck_p[1]).abs().max()))
    ck_ms = time_ms(torch, lambda: ck.compact_blocks(state_in, off))
    ck_plain_ms = time_ms(torch, lambda: ck.compact_blocks_plain(state_in,
                                                                 off))
    _, per, _, _ = device_times(torch,
                                lambda: ck.compact_blocks(state_in, off))
    pdev, _, _, _ = device_times(
        torch, lambda: ck.compact_blocks_plain(state_in, off))
    phase("compact_blocks", live=int((state_in[9] > 0).sum()),
          bit_identical=exact, ms=f"{ck_ms:.4f}", plain_ms=f"{ck_plain_ms:.4f}",
          device_ms=f"{kernel_ms(per, 'compact_kernel'):.4f}",
          plain_device_ms=f"{pdev:.4f}")
    require(exact, "compact_blocks differs from its plain version")

    # --- 4. main path ----------------------------------------------------
    render = make_render_fn(cam, bg, WIDTH, HEIGHT, SPP, BOUNCES, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render(scene)  # first render: allocator and cuDNN warm-up
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fbk.fused_bounce.launches = 0
    ck.compact_blocks.launches = 0
    t0 = time.perf_counter()
    img, segments = render(scene)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"fused_bounce": fbk.fused_bounce.launches,
                "compact_blocks": ck.compact_blocks.launches}
    img = img.cpu().numpy().astype(np.float64)
    oracle = np.load(ORACLE)["img"]
    require(img.shape == oracle.shape == (HEIGHT, WIDTH, 3),
            f"image shape {img.shape}")
    require(bool(np.isfinite(img).all()), "image has non-finite pixels")
    rmse = float(np.sqrt(np.mean((img - oracle) ** 2)))
    walls = [wall_s]  # four more warm renders give the run-to-run spread
    for _ in range(4):
        t0 = time.perf_counter()
        render(scene)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_s = statistics.median(walls)
    phase("render", config=f"{WIDTH}x{HEIGHT},spp={SPP},b={BOUNCES}",
          segments=segments, oracle_segments=ORACLE_SEGMENTS,
          rmse=f"{rmse:.6e}", first_render_s=f"{first_s:.4f}",
          wall_s=f"{wall_s:.4f}", walls_s=json.dumps([round(w, 4)
                                                      for w in walls]),
          mrays_per_s=f"{segments / wall_s / 1e6:.3f}",
          launches=json.dumps(launches), gpu=json.dumps(smi))
    require(all(n > 0 for n in launches.values()),
            f"a kernel did not run on the main path: {launches}")
    require(abs(segments - ORACLE_SEGMENTS) <= SEGMENT_SLACK,
            f"segments {segments} vs {ORACLE_SEGMENTS}")
    require(rmse < RMSE_BUDGET, f"RMSE {rmse} >= {RMSE_BUDGET}")

    # where the render's time goes: device time by kernel and the idle share
    # of one profiled render's own wall (the profiler's host cost included);
    # the full table goes to chiprun_out/
    busy_ms, per, n_ops, prof_wall_ms = device_times(
        torch, lambda: render(scene), reps=1)
    top = sorted(per.items(), key=lambda kv: -kv[1])
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "render_profile.txt"), "w") as f:
        f.write(f"{smi}\nwall_ms(profiled)={prof_wall_ms:.3f} "
                f"wall_ms(unprofiled median)={wall_s * 1e3:.3f} "
                f"device_busy_ms={busy_ms:.3f} device_ops={n_ops:.0f}\n")
        f.writelines(f"{ms:10.4f} ms  {name}\n" for name, ms in top)
    phase("render_profile", wall_ms=f"{prof_wall_ms:.3f}",
          device_busy_ms=f"{busy_ms:.3f}",
          device_idle_share=f"{1 - busy_ms / prof_wall_ms:.3f}",
          fused_bounce_ms=f"{kernel_ms(per, 'fused_bounce_kernel'):.3f}",
          compact_ms=f"{kernel_ms(per, 'compact_kernel'):.3f}",
          device_ops=f"{n_ops:.0f}", kernels_seen=len(per))

    # --- 5. CLI ----------------------------------------------------------
    os.makedirs(OUT, exist_ok=True)
    png = os.path.join(OUT, f"shirley_{WIDTH}x{HEIGHT}_spp{SPP}.png")
    if os.path.exists(png):
        os.remove(png)
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch", "shirley-spheres",
         f"--dimension={WIDTH},{HEIGHT}", f"--samples-per-pixel={SPP}",
         f"--max-ray-bounces={BOUNCES}", "--no-progress", "-o", png],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    require(cli.returncode == 0, f"CLI failed:\n{cli.stdout}\n{cli.stderr}")
    size = png_size(png)
    phase("cli", seconds=f"{time.perf_counter() - t0:.3f}",
          png=os.path.relpath(png, ROOT), size=f"{size[0]}x{size[1]}",
          said=json.dumps(cli.stdout.strip().splitlines()[-1]))
    require(size == (WIDTH, HEIGHT), f"PNG is {size}")

    kernels = [
        {"name": "fused_bounce", "route": "cuda",
         "source": "pathtracer_tpu_torch/csrc/fused_bounce.cu",
         "replaces": "pathtracer_tpu/ops/pallas/fused_bounce_kernel.py:123",
         "launches": launches["fused_bounce"], "max_abs_err": fb_err,
         "ms": fb_times[1][0], "plain_ms": fb_times[1][1]},
        {"name": "compact_blocks", "route": "cuda",
         "source": "pathtracer_tpu_torch/csrc/compact.cu",
         "replaces": "pathtracer_tpu/ops/pallas/compact_kernel.py:129",
         "launches": launches["compact_blocks"], "max_abs_err": ck_err,
         "ms": ck_ms, "plain_ms": ck_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
