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
     600x300 PNG (to chiprun_out/);
  6. PPM kernels: the photon mapper's three kernels against their plain
     versions, which they must equal exactly: intersect_spheres and
     intersect_tris on the cornell photon bounce-0 rays (75,776) and eye
     bounce-0 rays (360,448); gather_flux_chunks on the iteration-1 eye
     hits at r(1), the kernel over all 352 blocks and the plain version on
     32 of them (the 16 with the longest chunk lists and 16 evenly spaced
     others; blocks are independent), with times (CUDA events, and device
     time from the profiler);
  7. cornell render: `cornell-box 600x600, 10 iterations, 75,000 photons,
     4 bounces` through PPMRenderer.render (what the CLI calls), with the
     three kernels' launch counts, the first iteration's seconds and the
     median s/iter of iterations 2-10, the photon map length of each
     iteration against the reference file's (within 0.1%), the RMSE of the
     averaged linear image against
     scenes/ref_cornell_600x600_it10_pc75k_b4.npz (JAX on the CPU; below
     2e-3), and the device time by kernel and idle share of one warm
     iteration, profiled in a second render (table in
     chiprun_out/cornell_profile.txt);
  8. cornell CLI: `python -m pathtracer_tpu_torch cornell-box ...` (2
     iterations) writes a 600x600 PNG (to chiprun_out/).
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
# the cornell-box PPM path: the reference's default command
PPM_SIZE, PPM_ITERS, PPM_PHOTONS, PPM_BOUNCES = 600, 10, 75_000, 4
PPM_REF = os.path.join(ROOT, "scenes", "ref_cornell_600x600_it10_pc75k_b4.npz")
PPM_RMSE_BUDGET = 2e-3
PPM_LENGTH_SLACK = 1e-3  # photon map length, relative to the reference's
GATHER_LONGEST = GATHER_SPACED = 16  # blocks the plain gather is held on
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
    fn()
    torch.cuda.synchronize()
    with profiler() as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    return (*device_per_kernel(prof, reps), wall_ms)


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def device_per_kernel(prof, reps: int):
    """(total device ms, {kernel name: device ms}, device operations), per
    call of a profile that spans `reps` calls."""
    from torch.autograd import DeviceType
    per = {}
    n_ops = 0
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)):
            per[e.key] = per.get(e.key, 0.0) + (e.self_device_time_total
                                                / reps / 1e3)
            n_ops += e.count
    return sum(per.values()), per, n_ops / reps


def kernel_ms(per: dict, name: str) -> float:
    return sum(ms for key, ms in per.items() if name in key)


def png_size(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        head = f.read(24)
    require(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR",
            f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def compare(torch, name, fn_k, fn_p, what, kernel, plain_reps=7,
            plain_batch=10, plain_prof=5, **fields):
    """Run a kernel wrapper and its plain version on the same inputs; print
    and require equality of every output; time both (the plain version
    over plain_reps x plain_batch calls, profiled over plain_prof). kernel:
    the CUDA kernel's name in the profile. Returns (max abs difference,
    kernel ms, plain ms, the plain version's outputs)."""
    got, want = fn_k(), fn_p()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max(float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
              for g, w in zip(got, want))
    kms = time_ms(torch, fn_k)
    pms = time_ms(torch, fn_p, reps=plain_reps, batch=plain_batch)
    _, per, _, _ = device_times(torch, fn_k, reps=5)
    pdev, _, _, _ = device_times(torch, fn_p, reps=plain_prof)
    phase(name, shape=what, equal=exact, max_abs_err=err, ms=f"{kms:.4f}",
          plain_ms=f"{pms:.4f}", device_ms=f"{kernel_ms(per, kernel):.4f}",
          wrapper_device_ms=f"{sum(per.values()):.4f}",
          plain_device_ms=f"{pdev:.4f}", **fields)
    require(exact, f"{name} ({what}): the kernel differs from its plain "
            f"version (max abs {err})")
    return err, kms, pms, want


def ppm_phases(torch, np, dev, smi):
    """Phases 6-8: the photon mapper's kernels, the cornell render and its
    CLI. Returns (kernel JSON entries without launches, launch counts of
    the render)."""
    from pathtracer_tpu_torch import ppm
    from pathtracer_tpu_torch.models import cornell
    from pathtracer_tpu_torch.ops.cuda import gather_kernel as gk
    from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk
    from pathtracer_tpu_torch.ops.cuda import tri_kernel as tk
    from pathtracer_tpu_torch.scene import TRI_A, TRI_E1, TRI_E2

    size, iters, photons, bounces = (PPM_SIZE, PPM_ITERS, PPM_PHOTONS,
                                     PPM_BOUNCES)
    # --- 6. kernels vs their plain versions, at the cornell shapes ------
    scene, cam, lights = cornell.build(1.0, dev)
    sph = sk.pack_spheres(scene.center, scene.radius, scene.valid)
    tp = scene.tri_pack
    tri = tk.pack_tris(tp[:, TRI_A], tp[:, TRI_E1], tp[:, TRI_E2],
                       scene.tri_valid)
    trace, _, _ = ppm.make_photon_pass(scene, lights, photons, bounces)
    eye = ppm.make_eye_pass(cam, size, size, bounces, photons, scene)
    _, p_org, p_d, _, p_alive = trace.emit(0)
    _, e_org, e_d, e_alive = eye.primary(0)
    require(p_org.shape[0] == 75_776 and e_org.shape[0] == 360_448,
            f"rays {p_org.shape[0]}, {e_org.shape[0]}")
    times = {}
    for label, org, d, alive in (("photon_b0", p_org, p_d, p_alive),
                                 ("eye_b0", e_org, e_d, e_alive)):
        args = (org.contiguous(), d.contiguous(), alive)
        err_s, kms, pms, _ = compare(
            torch, "intersect_spheres",
            lambda: sk.intersect_spheres(sph, *args),
            lambda: sk.intersect_spheres_plain(sph, *args),
            f"{label}:{org.shape[0]}x{sph.shape[1]}",
            kernel="intersect_spheres_kernel")
        times[("intersect_spheres", label)] = (err_s, kms, pms)
        err_t, kms, pms, _ = compare(
            torch, "intersect_tris",
            lambda: tk.intersect_tris(tri, *args),
            lambda: tk.intersect_tris_plain(tri, *args),
            f"{label}:{org.shape[0]}x{tri.shape[1]}",
            kernel="intersect_tris_kernel")
        times[("intersect_tris", label)] = (err_t, kms, pms)

    # the gather at iteration 1: the render's photons, eye hits and radius
    rend = ppm.PPMRenderer(scene, cam, lights, size, size, iterations=iters,
                           photon_count=photons, max_bounces=bounces,
                           verbose=False)
    r1 = rend.radius(1)
    pos, nrm, flux, ok, _ = trace(0)
    photons_t, sbox = gk.build_photon_chunks(pos, nrm, flux, ok)
    pt, nm, _, act = eye.walk(0)
    perm = torch.argsort(gk.hit_morton_keys(pt, act), stable=True)
    pt, nm, act = pt[perm].contiguous(), nm[perm].contiguous(), act[perm]
    _, counts = gk.block_chunk_lists(pt, act, sbox, r1)
    nblk = counts.shape[0]
    longest = torch.argsort(counts, descending=True, stable=True)[
        :GATHER_LONGEST].tolist()
    spaced = [b for b in np.linspace(0, nblk - 1, GATHER_SPACED + 8)
              .round().astype(int).tolist() if b not in longest]
    blocks = sorted(longest + spaced[:GATHER_SPACED])
    rows = torch.cat([torch.arange(b * 1024, (b + 1) * 1024, device=dev)
                      for b in blocks])
    sub = (pt[rows].contiguous(), nm[rows].contiguous(), act[rows])
    full = gk.gather_flux_chunks(pt, nm, act, sbox, photons_t, r1)
    torch.cuda.synchronize()
    err_g, g_ms_sub, g_plain_ms, (want_rows,) = compare(
        torch, "gather_flux_chunks",
        lambda: gk.gather_flux_chunks(*sub, sbox, photons_t, r1),
        lambda: gk.gather_flux_chunks_plain(*sub, sbox, photons_t, r1),
        f"{len(blocks)}_of_{nblk}_blocks", kernel="gather_chunks_kernel",
        plain_reps=3, plain_batch=1, plain_prof=1,
        list_lengths=json.dumps(counts[blocks].tolist()))
    require(torch.equal(full[rows], want_rows),
            "the full-size gather differs from the plain version on the "
            "checked blocks")
    g_ms = time_ms(torch, lambda: gk.gather_flux_chunks(
        pt, nm, act, sbox, photons_t, r1))
    _, per, _, _ = device_times(torch, lambda: gk.gather_flux_chunks(
        pt, nm, act, sbox, photons_t, r1), reps=5)
    phase("gather_flux_chunks_full", hits=pt.shape[0], blocks=nblk,
          photon_columns=photons_t.shape[1], radius=f"{r1:.6f}",
          list_max=int(counts.max()), list_mean=f"{float(counts.float().mean()):.2f}",
          ms=f"{g_ms:.4f}",
          device_ms=f"{kernel_ms(per, 'gather_chunks_kernel'):.4f}",
          wrapper_device_ms=f"{sum(per.values()):.4f}")

    # --- 7. the cornell render -------------------------------------------
    counters = {"intersect_spheres": sk.intersect_spheres,
                "intersect_tris": tk.intersect_tris,
                "gather_flux_chunks": gk.gather_flux_chunks}
    for fn in counters.values():
        fn.launches = 0
    marks = []

    def tick(i, img_sum):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_sum = rend.render(checkpoint_cb=tick)
    launches = {k: fn.launches for k, fn in counters.items()}
    iter_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    lengths = [int(n) for n in rend.photon_map_lengths]
    segments = [int(s) for s, _ in rend.iter_segments]
    ref = np.load(PPM_REF)
    img = img_sum.cpu().numpy() / iters
    require(img.shape == ref["img"].shape == (size, size, 3),
            f"image shape {img.shape}")
    require(bool(np.isfinite(img).all()), "image has non-finite pixels")
    rmse = float(np.sqrt(np.mean((img - ref["img"].astype(np.float64)) ** 2)))
    ref_len = [int(n) for n in ref["photon_map_lengths"]]
    len_err = max(abs(a - b) / b for a, b in zip(lengths, ref_len))
    phase("cornell_render",
          config=f"{size}x{size},iters={iters},photons={photons},"
                 f"b={bounces}",
          first_iter_s=f"{iter_s[0]:.4f}",
          median_s_per_iter=f"{statistics.median(iter_s[1:]):.4f}",
          iter_s=json.dumps([round(t, 4) for t in iter_s]),
          photon_map_lengths=json.dumps(lengths),
          reference_lengths=json.dumps(ref_len),
          max_length_rel_err=f"{len_err:.3e}",
          photon_segments=json.dumps(segments), rmse=f"{rmse:.6e}",
          launches=json.dumps(launches), gpu=json.dumps(smi))
    require(all(n > 0 for n in launches.values()),
            f"a kernel did not run on the cornell path: {launches}")
    require(len_err <= PPM_LENGTH_SLACK,
            f"photon map lengths {lengths} vs {ref_len}")
    require(rmse < PPM_RMSE_BUDGET, f"cornell RMSE {rmse} >= "
            f"{PPM_RMSE_BUDGET}")

    # device time of one warm iteration: a second render of the same
    # renderer, profiled from the end of its iteration 1 to the end of its
    # iteration 2 (no per-render set-up inside the window); the idle share
    # of that iteration's own wall, and of the unprofiled median beside it
    prof = profiler()
    window = {}

    def prof_tick(i, img_sum):
        torch.cuda.synchronize()
        if i == 0:
            prof.start()
            window["t0"] = time.perf_counter()
        elif i == 1:
            window["ms"] = (time.perf_counter() - window["t0"]) * 1e3
            prof.stop()

    rend.render(checkpoint_cb=prof_tick)
    prof_wall_ms = window["ms"]
    median_ms = statistics.median(iter_s[1:]) * 1e3
    busy_ms, per, n_ops = device_per_kernel(prof, 1)
    top = sorted(per.items(), key=lambda kv: -kv[1])
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "cornell_profile.txt"), "w") as f:
        f.write(f"{smi}\nwall_ms(profiled iteration)={prof_wall_ms:.3f} "
                f"wall_ms(unprofiled median)={median_ms:.3f} "
                f"device_busy_ms={busy_ms:.3f} device_ops={n_ops:.0f}\n")
        f.writelines(f"{ms:10.4f} ms  {name}\n" for name, ms in top)
    phase("cornell_profile", wall_ms=f"{prof_wall_ms:.3f}",
          unprofiled_median_ms=f"{median_ms:.3f}",
          device_busy_ms=f"{busy_ms:.3f}",
          device_busy_share=f"{busy_ms / prof_wall_ms:.3f}",
          device_idle_share=f"{1 - busy_ms / prof_wall_ms:.3f}",
          device_idle_share_of_median=f"{1 - busy_ms / median_ms:.3f}",
          intersect_spheres_ms=f"{kernel_ms(per, 'intersect_spheres_kernel'):.3f}",
          intersect_tris_ms=f"{kernel_ms(per, 'intersect_tris_kernel'):.3f}",
          gather_ms=f"{kernel_ms(per, 'gather_chunks_kernel'):.3f}",
          device_ops=f"{n_ops:.0f}", kernels_seen=len(per))

    # --- 8. the cornell CLI ----------------------------------------------
    png = os.path.join(OUT, f"cornell_{size}x{size}.png")
    if os.path.exists(png):
        os.remove(png)
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch", "cornell-box",
         "-width", str(size), "-height", str(size), "-iterations", "2",
         "-photon-count", str(photons), "-max-bounces", str(bounces),
         "-no-progress", "-o", png],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    require(cli.returncode == 0,
            f"cornell CLI failed:\n{cli.stdout}\n{cli.stderr}")
    png_wh = png_size(png)
    phase("cornell_cli", seconds=f"{time.perf_counter() - t0:.3f}",
          png=os.path.relpath(png, ROOT), size=f"{png_wh[0]}x{png_wh[1]}",
          said=json.dumps(cli.stdout.strip().splitlines()[-1]))
    require(png_wh == (size, size), f"PNG is {png_wh}")

    src = "pathtracer_tpu_torch/csrc/"
    pallas = "pathtracer_tpu/ops/pallas/"
    entry = lambda name, source, replaces, err, kms, pms, **kw: dict(
        name=name, route="cuda", source=src + source,
        replaces=pallas + replaces, max_abs_err=err, ms=kms, plain_ms=pms,
        **kw)
    kernels = [
        entry("intersect_spheres", "intersect_spheres.cu",
              "sphere_kernel.py:302", *times[("intersect_spheres", "eye_b0")],
              shape="eye bounce-0 rays, 360448"),
        entry("intersect_tris", "intersect_tris.cu", "tri_kernel.py:140",
              *times[("intersect_tris", "eye_b0")],
              shape="eye bounce-0 rays, 360448"),
        entry("gather_flux_chunks", "gather_chunks.cu",
              "gather_kernel.py:468", err_g, g_ms_sub, g_plain_ms,
              shape=f"{len(blocks)} of {nblk} blocks at iteration 1",
              ms_all_blocks=g_ms),
    ]
    return kernels, launches


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

    ppm_kernels, ppm_launches = ppm_phases(torch, np, dev, smi)

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
    for k in ppm_kernels:
        k["launches"] = ppm_launches[k["name"]]
    kernels += ppm_kernels
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
