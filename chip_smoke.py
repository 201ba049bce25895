#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pathtracer_tpu_torch) on one NVIDIA
GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:
  1. device: the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
  2. build: nvcc builds csrc/*.cu for sm_90a (timed);
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, which it must equal exactly, at the shapes of the canonical
     render (600x300 in 32x32 tiles: 190 tiles, 194,560 rays): the
     sphere hierarchy's groups and leaves and its host build ms; the fused
     bounce at every bounce of pass 0 (compacted before bounce 3, as the
     render does), with device times, at bounces >= 1 the sphere walk's
     leaves and node tests per warp, pairs tested and both bounds (brute
     force and under the walk), and the plain version's times at bounces
     0 and 1 (median of 7 after a warm-up, CUDA events), and
     intersect_state against its plain version on each of those states;
     compaction; then the two-kernel bounce's intersect_state (bounce 0
     listed and origin-zero, bounce 1 full) and shade_state against their
     plain versions, and their chain against fused_bounce, all equal, with
     the host's microseconds per call of the three wrappers;
  4. main path: `shirley-spheres 600x300 spp=32 b=8` through make_render_fn
     (what the CLI calls), with the kernels' launch counts, the segment
     count and the RMSE against the committed float64 oracle, the median
     wall time of 5 warm renders, and one profiled render's device time by
     kernel and idle share of its own wall (full table in
     chiprun_out/render_profile.txt);
  4b. two-kernel render: the same render with fuse_bounce=False, with the
     two kernels' launch counts (fused_bounce: none), its segments and
     image equal to the fused render's, its RMSE against the oracle, the
     median wall of 6 warm renders beside 6 of the fused render, the two
     alternated, and one profiled render's device time by kernel;
  4c. clustered: intersect_clustered on shirley's 178 clusters against its
     plain version on the bounce-1 rays of phase 3 (equal), then against
     intersect_spheres on the same rays (hit and at equal on every live
     lane, and on every lane with all lanes alive; idx mismatches printed),
     with both kernels' times; the kernel's walk from its plain emulation
     (equal to the plain version): the blocks' surviving clusters, the
     clusters each warp enters and the real pairs its lanes test (mean and
     max), the lanes outside the warp skip's proof; its three bounds (the
     block cull's work, the walked work, the brute force); the host ms of
     its first cached_cluster_walk; and its device ms beside the device ms
     before its redesign;
  5. CLI: `python -m pathtracer_tpu_torch shirley-spheres ...` writes a
     600x300 PNG (to chiprun_out/);
  6. PPM kernels: the photon mapper's three kernels against their plain
     versions, which they must equal exactly: intersect_spheres and
     intersect_tris on the cornell photon bounce-0 rays (75,776) and eye
     bounce-0 rays (360,448), intersect_tris with the host's microseconds
     per call, its real columns and the live pairs that reach its full
     test (tri_pair_tests, which must find no skipped pair accepted);
     gather_flux_chunks on the iteration-1 eye
     hits at r(1), the kernel over all 352 blocks and the plain version on
     32 of them (the 16 with the longest chunk lists and 16 evenly spaced
     others; blocks are independent), with times (CUDA events, and device
     time from the profiler, beside the one-CTA-per-list kernel's), its
     work items (segments of SEG list positions: count, the heaviest), the
     hit-photon pairs its lists hold and those its warps walk, and its
     bound, counted on the walked pairs, over the 32 blocks and over all
     352; then the raster-grid gather on the same
     photons and eye hits: the grid from ppm._build_grid_morton_device,
     query_tables, hits sorted by their cell's Morton key, gather_flux on
     all blocks against its plain version on 32 (the 16 with the longest
     ranges and 16 spaced), equal, and on all lanes against
     gather_flux_chunks (the same photons summed in another order: rtol
     1e-4, atol 1e-6), with times and cell / r, and what sets its time:
     the longest lane's pairs and longest single range, the lanes over
     4,096 and 16,384 pairs, the pairs over 32 x each warp's longest lane,
     the distinct ranges per warp and offset, and the longest block alone;
  7. cornell render: `cornell-box 600x600, 10 iterations, 75,000 photons,
     4 bounces` through PPMRenderer.render (what the CLI calls), with the
     three kernels' launch counts, the eye walk's live lanes and lanes
     (the ppm.walk_live and ppm.walk_lanes counters of the render's
     record) and their ratio, the first iteration's seconds and the
     median s/iter of iterations 2-10, the host's wait at the gather's
     read of its item count, the photon map length of each
     iteration against the reference file's (within 0.1%), the RMSE of the
     averaged linear image against
     scenes/ref_cornell_600x600_it10_pc75k_b4.npz (JAX on the CPU; below
     2e-3), and the device time by kernel and idle share of one warm
     iteration, profiled in a second render (table in
     chiprun_out/cornell_profile.txt);
  8. cornell CLI: `python -m pathtracer_tpu_torch cornell-box ...` (2
     iterations) writes a 600x600 PNG (to chiprun_out/);
  9. mesh: g++ builds native/bvh_build.cc (timed), scenes/big_ganesha.ply
     loads into a MeshBVH (449,352 triangles: depth, walk-table rows,
     build seconds) and the renderer builds its tile table (columns, list
     length mean and max);
 10. mesh kernels against their plain versions, which they must equal
     exactly: bvh8_walk on iteration 1's photon rays of every bounce
     (bounces 0 and 1 timed against the plain version)
     (75,776 lanes, t_max0 the pool winner's t; the plain version over all
     lanes, which also counts each lane's steps and the table rows read);
     intersect_tris on the floor pool (2 real columns of 128) and
     iteration 1's photon bounce-0 rays;
     intersect_tile_tris on iteration 1's eye primaries (608 x 600 rays),
     the plain version on 32 tiles (the 16 with the longest lists and 16
     spaced) and the kernel on the same tiles and on all 361, with its
     work items (one per 256-triangle chunk) and device time beside the
     one-CTA-per-tile kernel's;
 11. ganesha eye pass and render: first the eye pass alone, at 600x600
     over the JAX reference's own iteration-1 deposits, against the JAX
     image of that iteration (scenes/ref_ganesha_600x600_it1_photons.npz;
     RMSE within 0.5% of its RMS), with the gather's lists and items there
     and its time; then `ganesha 600x600, 10 iterations,
     75,000 photons, 4 bounces` through PPMRenderer.render, with the five
     kernels' launch
     counts, the first iteration's seconds and the median s/iter of
     iterations 2-10, the host's wait at the gather's read, photon map
     lengths against the reference file's (within 0.1%), the RMSE against
     scenes/ref_ganesha_600x600_it10_pc75k_b4.npz (JAX on the CPU) and the
     RMSE of 8x8-pixel means (budgets below), and one profiled warm
     iteration (table in chiprun_out/ganesha_profile.txt);
 12. ganesha CLIs: `ganesha ... -iterations 2` writes a 600x600 PNG,
     `ganesha -stop-after-bvh` prints the mesh's statistics, and
     `ply-describe scenes/test_ganesha.ply` runs;
 13. path-traced ganesha: phase 9's floor, camera and MeshBVH under the
     shirley sky (what models.ganesha.build_pt returns): the renderer's
     flip_y tile table (its host seconds, columns, list mean and max);
     intersect_tile_tris on pass 0's primaries over that table, the plain
     version on 32 tiles (as in phase 10); bvh8_walk against its plain
     version on pass 0's bounce-1 and bounce-3 rays (365,568 lanes leaving
     the floor and the mesh), with steps per lane from the plain version's
     count_steps, its times and bound; intersect_spheres and
     intersect_tris against their plain versions on the bounce-1 rays;
     winner_t and mesh_bounce against their plain version (composite_hits
     after the mesh query, scatter_bounce) at bounces 0, 1 and 3 of pass
     0 (mesh_bounce_kernel.plain_bounces and bounce_equal: torch.equal on
     t_cur, org, d, attn, rad and alive, segments the live lanes), each
     with its warm and L2-flushed ms, device ms and bound by bytes;
     then `600x600 spp=8 b=8` through make_render_fn(..., mesh=mesh): the
     six kernels' launch counts (intersect_spheres, intersect_tris,
     bvh8_walk, intersect_tile_tris, winner_t, mesh_bounce: 64, 64, 56, 8,
     64, 64), the live lanes of each
     bounce of pass 0, the segments within 0.1% of the reference's
     (scenes/ref_ganesha_pt_600x600_spp8_b8.npz, JAX on the CPU; the TPU's
     count printed beside), the image's RMSE and 8x8-binned RMSE as shares
     of the reference's RMS (budgets below), the first render's seconds
     and the median wall of 3 warm renders, a PNG, and one profiled
     render's device busy, idle share and time by kernel with the walk's
     device ms by bounce (chiprun_out/ganesha_pt_profile.txt).
 14. multi-device (pathtracer_tpu_torch.parallel), four lines and a
     total: (a) in this process, an NCCL group of one: the shirley render
     through make_sharded_render_fn equal to phase 4's image and
     segments, the path-traced ganesha's to phase 13's, and the Renderer
     bands at sp = 2 and 4 and the MeshRenderer bands at sp = 2, stitched
     and filtered, equal to those images; cornell's replicated map and
     the ganesha ring, 2 iterations each, in the group (the references of
     (b)); and intersect_tile_tris over band_tile_maps of phase 11's table
     (tile rows 0-9, and 10-19 with row 19 past the image) equal to its
     plain version on the same maps; (b) two gloo ranks sharing the
     card, one group.spawn of this script's rank_runs (NCCL refuses two
     ranks on one GPU): shirley at (dp, sp) = (1, 2) and the path-traced
     ganesha at (1, 2) equal to phases 4 and 13, (2, 1) within atol 1e-5
     with equal segments; then cornell 600x600, 2 iterations: the
     replicated map equal to (a)'s group of one (the same 256-row bands),
     the sharded and ring maps within atol 1e-6 / rtol 1e-4 of it, the
     map lengths equal to phase 7's first two, and the ganesha ring within
     the same bounds of (a)'s; each rank's launches, walls per render and
     one ring hop's ms of a sub-grid (gloo through host memory); (c)
     `cornell-box -shard-photon-map ring` under `torchrun` (one process)
     prints `backend = nccl` and writes a 600x600 PNG.
 15. the BVH4 walk: (a) phase 9's triangles on the BVH4 table
     (MeshBVH(walk="bvh4"), through models.ganesha.build): its rows,
     node_end, stride and host build seconds; bvh4_walk against its plain
     version (equal) on the ganesha photon bounce-0 and bounce-1 rays and
     on the path-traced pass 0's bounce-1 and bounce-3 rays, with steps per
     active lane, the kernel's own steps from its plain emulation
     bvh4_walk_cached_plain (required equal too: table loads mean and max,
     path-cache hits and misses, two-row leaf steps, the share of returns
     served from the cache), its counters (required equal to the active
     lanes and the emulation's table loads), its CUDA-event ms and its
     device ms (events around launches enqueued behind a device sleep;
     counters on, as MeshBVH launches it) beside bvh8_walk's on
     the same rays (phase 9's table), its bound and share of it, and the
     lanes whose hit, t or idx differ from bvh8_walk's (required 0); then
     the ganesha
     600x600 10-iteration PPM render (phase 11's gates) and the
     path-traced 600x600 spp=8 b=8 render (phase 13's gates) on it, with
     launches, first seconds and walls beside phases 11 and 13; (b)
     big_ganesha subdivided 4:1 at its edge midpoints (1,797,408
     triangles), written to chiprun_out/ (removed at the phase's end):
     native.bvh8_table refuses it (its rows against 2^24 / 8), build_pt
     takes the BVH4 walk (rows, table MB, host seconds of the BVH build,
     the walk table and the tile table), bvh4_walk on its path-traced
     pass 0's bounce-1 and bounce-3 rays as in (a), the path-traced
     render on it holds phase 13's gates and its walk counters (rays
     equal to its segments less the primaries, more loads), and the ganesha CLI renders it at 600x600 (2
     iterations, map lengths printed beside the reference's) and prints
     its statistics with -stop-after-bvh.
 16. the seeded shirley scene and 16 bounces: (a) models.shirley.build(
     seed=7, use_manifest=False) (530 spheres, S = 536): its sphere
     hierarchy (unconditional spheres, groups, leaves, host build ms), the
     fused bounce at every bounce of pass 0 (bounce 0 listed over its own
     tile lists, the rest full over its hierarchy; compacted before bounce
     3 as the render does) and that compaction equal to their plain
     versions, intersect_clustered equal to its plain version on the
     bounce-1 rays (its cluster count and shared memory printed) and to
     intersect_spheres' hits, then `600x300 spp=32 b=8` of it through
     make_render_fn: RMSE below 1e-3 against
     scenes/oracle_shirley_seed7_600x300_spp32_f64.npz and segments within
     3,000 of its count, launches, and the median wall of 5 warm renders
     beside phase 4's; (b) one make_render_fn at 160x80 spp=4 b=8 renders
     seed 42, seed 7, then seed 42 again, each image and segment count
     equal to a fresh render function's; (c) the seed-42 scene at 600x300
     spp=32 b=16 (compaction at bounces 2 and 4): RMSE below 1e-3 against
     scenes/oracle_shirley_600x300_spp32_b16_f64.npz, segments within
     0.05% of its count; then bench.py's HQ render, spp=512 b=16: segments
     within 0.1% of the JAX package's 236,462,441 on the TPU (BENCH_r05),
     with its wall and the card's name and power limit. Every render of
     phase 16 runs fused_bounce and compact_blocks and no other kernel.
Each kernel's bound_ms in the JSON line is the larger of the bytes it must
move over 3.35 TB/s and its float32 operations over 67 TFLOP/s, counted
from this run's inputs (OPS below); for the full-variant sphere loop
(fused_bounce, intersect_state) that is the walk's node tests and pairs,
with the brute force's bound beside it as bound_ms_brute; for the
clustered kernel the least of its three bounds. The clustered
kernel and the raster gather are on no render path, and the BVH4 walk on
none before phase 15: their counts are set to 0 with the path's own
before each of the six main-path runs of phases 4-14 in this process (4,
4b, 7, 11, 13, 14a) and around 14b's ranks' renders, read after it, and
must stay 0; around phase 15's three renders the BVH4 walk must run and
the BVH8 walk, the clustered kernel and the raster gather must not;
around each of phase 16's renders (the seed-7, scene-switch, 16-bounce and
HQ paths) only fused_bounce and compact_blocks may run. Every other
kernel's launches sum its one-process paths' runs (4, 7, 11, 13, 15, 16:
fused_bounce's and compact_blocks' include phase 16's renders);
launches_by_path adds 14a's and 14b's (each rank's counts, read around
its renders, summed).
Then a JSON line of kernel results, the nvidia-smi line, and the final
`{"ok": true, "device": {...}}` line. Without a CUDA device, or without the
package beside this script, it fails before printing any result.

    python3 chip_smoke.py --sweep-seg

instead times the chunk gather at each SEG of SWEEP_SEGS (sweep_seg).
"""

from __future__ import annotations

import dataclasses
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
# the ganesha PPM path: the reference's default ganesha command
GANESHA_PLY = os.path.join(ROOT, "scenes", "big_ganesha.ply")
GANESHA_REF = os.path.join(ROOT, "scenes",
                           "ref_ganesha_600x600_it10_pc75k_b4.npz")
GANESHA_TRIS = 449_352
# RMSE budget, as a share of the reference image's RMS (0.051307). The
# gather radius is under a pixel (r(1) = 0.160 camera units, a pixel ~0.2 at
# the statue), so a pixel's value is one or two photons, and a photon path
# that an ulp of sin/cos sends across one of the 449k triangles' edges moves
# a whole pixel: of the 83,226 deposits of iteration 1, 15 land elsewhere
# and 5 are valid in one package only, between the port and the JAX package
# both on the CPU (tools/ganesha_photon_divergence.py). Measured on the card
# (NVIDIA H100 80GB HBM3, 700 W): RMSE 5.70e-4, 1.11% of the RMS, from
# single pixels; neighbouring pixels agree within a few percent.
GANESHA_RMSE_SHARE = 2e-2
# the quality check that averages those single-pixel photons out: the RMSE
# of the image in 8x8-pixel means, as a share of the same means' RMS
GANESHA_BINNED_SHARE = 5e-3
# the eye pass alone, with the photon paths taken out: iteration 1's image
# over the JAX reference's own deposits (tools/make_ganesha_reference.py
# --witness), RMSE as a share of that image's RMS, at the 0.5% budget
GANESHA_WITNESS = os.path.join(ROOT, "scenes",
                               "ref_ganesha_600x600_it1_photons.npz")
GANESHA_WITNESS_SHARE = 5e-3
TILE_LONGEST = TILE_SPACED = 16  # tiles the plain tile kernel is held on
# the path-traced ganesha: bench.py's `_run_ganesha_pt` configuration and
# its JAX reference (tools/make_ganesha_pt_reference.py, XLA on the CPU)
PT_SIZE, PT_SPP, PT_BOUNCES = 600, 8, 8
GANESHA_PT_REF = os.path.join(ROOT, "scenes",
                              "ref_ganesha_pt_600x600_spp8_b8.npz")
GANESHA_PT_TPU_SEGMENTS = 7_827_580  # BENCH_r05, printed beside, not held
PT_SEGMENT_SLACK = 1e-3  # segments, relative to the reference's
# image budgets, as shares of the reference's RMS: the ganesha PPM's (a
# path that an ulp turns across one of the mesh's edges changes its
# pixel's sample; 8x8 means average such single samples out)
GANESHA_PT_RMSE_SHARE = 2e-2
GANESHA_PT_BINNED_SHARE = 5e-3
PT_WALK_BOUNCES = (1, 3)  # bounces whose walk is held to its plain version
# bounces whose mesh_bounce and winner_t are held to their plain version
PT_BOUNCE_CHECKS = (0, 1, 3)
PT_WARM_RENDERS = 3
# phase 16: a seeded shirley scene other than the manifest's (seed 7's own
# list, 530 spheres) and the 16-bounce chain of the HQ configuration, each
# against a float64 render of the JAX package on the CPU
# (tools/make_shirley_reference.py); the canonical render's budgets for the
# seed-7 render, and for 16 bounces segments within 0.05%
SEED = 7
SEED_ORACLE = os.path.join(ROOT, "scenes",
                           "oracle_shirley_seed7_600x300_spp32_f64.npz")
B16, B16_SEGMENT_SLACK = 16, 5e-4
B16_ORACLE = os.path.join(ROOT, "scenes",
                          "oracle_shirley_600x300_spp32_b16_f64.npz")
# bench.py's HQ configuration (spp 512, 16 bounces) and the segments the
# JAX package traced there on the TPU (BENCH_r05): segments, not a speed
HQ_SPP, HQ_TPU_SEGMENTS, HQ_SEGMENT_SLACK = 512, 236_462_441, 1e-3
SWITCH_W, SWITCH_H, SWITCH_SPP = 160, 80, 4  # the scene switch's render
# The card's peaks for bound_ms (NVIDIA's H100 SXM data sheet): HBM 3.35
# TB/s and 67 TFLOP/s of float32 outside the tensor cores.
HBM_BYTES_PER_MS = 3.35e12 / 1e3
FP32_OPS_PER_MS = 67e12 / 1e3
# float32 operations per unit of work, counted in the CUDA sources
# (compares and integer work not counted): a ray-sphere test of
# intersect_spheres.cu and intersect_clustered.cu (20) and of the sphere
# loop of pt_bounce.cuh, which fused_bounce.cu and intersect_state.cu run
# (18; 9 for the origin-zero bounce 0 over the per-block lists), a
# ray-cluster cull test of intersect_clustered.cu (17), the shading of a
# lane that hit (shade_lane of pt_bounce.cuh, ~300 with sinf and cosf at
# 20 each) and of one that missed (17), a ray-triangle test of
# intersect_tris.cu and bvh8_walk.cu (46), and a pair of intersect_tris.cu
# that leaves at its |det| test (14: pvec, det), at its u tests (23: tvec,
# U, |det| M1) or at its v, t and u + v tests (44: qvec, V, Tn, the sum,
# |det| M2), the origin-zero test of intersect_tile_tris.cu (44), a
# hit-photon pair of gather_chunks.cu and gather_flux.cu that adds (22),
# and one of gather_flux.cu outside r (8: d^2) or inside r and facing away
# (13: d^2, n . n_p), a node row of bvh8_walk.cu (185: 9 for the ray's
# frame, 8 children x 3 axes x 6 slab operations, 32 for the children's
# min/max reductions), and a node test of the sphere hierarchy's walk in
# pt_bounce.cuh or a grown-bound test of intersect_clustered.cu's walk (17),
# and a node row of bvh4_walk.cu (88: 4 children x 3 axes x 6 slab
# operations, 16 for the children's min/max reductions).
OPS = dict(sphere=20, fused_sphere=18, listed_sphere=9, cull=17, shade=300,
           shade_miss=17, tri=46, tri_det=14, tri_u=23, tri_vt=44,
           tile_tri=44, gather=22, gather_far=8, gather_near=13, node=185,
           sphere_node=17, node4=88)
# blocks the plain raster gather is held on
RASTER_LONGEST = RASTER_SPACED = 16
# device ms of the one-CTA-per-list kernels that the split-list kernels
# replaced (PERF.md, §6; NVIDIA H100 80GB HBM3, 700 W): the chunk gather
# on cornell iteration 1 over all 352 blocks and over the 32 checked
# ones, and in the profiled cornell and ganesha iterations; the tile
# kernel over ganesha's 361 tiles
BEFORE_SPLIT_MS = dict(gather_all_blocks=8.120, gather_checked_blocks=7.840,
                       gather_cornell_iteration=6.00,
                       gather_ganesha_iteration=4.296, tile=3.109)
# device ms of the kernels before the sphere hierarchy's walk and the
# grouped BVH8 walk replaced their loops (PERF.md, §6; NVIDIA H100 80GB
# HBM3, 700 W): the full fused bounce and intersect_state at shirley
# bounce 1, the fused kernel's sum over one shirley render, and the BVH8
# walk at ganesha photon bounce 0
BEFORE_CULL_MS = dict(fused_bounce=0.1439, intersect_state=0.1149,
                      fused_bounce_render=23.51, bvh8_walk=0.173)
# device ms of the triangle-pool kernel and the raster gather before their
# redesign for this card, as the previous version of this script read them
# in one call with the redesigned kernels (PERF.md, §6; NVIDIA H100 80GB
# HBM3, 700 W): the triangle kernel on cornell's photon and eye bounce-0
# rays and in the profiled cornell and ganesha iterations; the raster
# gather over all 352 blocks of cornell iteration 1 (CUDA events: the
# profiler recorded none)
BEFORE_REDESIGN_MS = dict(intersect_tris_photon_b0=0.0356,
                          intersect_tris_eye_b0=0.0692,
                          intersect_tris_cornell_iteration=0.652,
                          intersect_tris_ganesha_iteration=0.419,
                          gather_flux_events=1.8247)
# ms of the clustered sphere kernel before its redesign for this card
# (PERF.md, §6; NVIDIA H100 80GB HBM3, 700 W): shirley bounce-1 rays
# against 178 clusters, profiler and CUDA events
BEFORE_CLUSTERED_MS = dict(device=0.5489, events=0.9367)
# list positions per gather work item tried by --sweep-seg
SWEEP_SEGS = (4, 8, 16, 32, 64)
# Kernel vs plain on the card: none. The kernels are built without FMA
# contraction and fast math and round every operation as the plain versions
# do, so state, radiance and alive flags must be equal. (The 1e-2 / 1e-6
# tolerances of tests/test_torch_fused_bounce.py are for the port against
# XLA, which contracts FMAs.)


T_START = time.perf_counter()


def phase(name: str, **fields) -> None:
    """Print one phase line, led by the seconds since the script started."""
    print(f"[{name}] t={time.perf_counter() - T_START:.1f}s "
          + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def bound(n_bytes: float, n_ops: float) -> dict:
    """bound_ms and bound_by: the larger of the bytes over the HBM rate and
    the float32 operations over the FP32 peak."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_MS, n_ops / FP32_OPS_PER_MS
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


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


def time_cold_ms(torch, fn, reps: int = 7, prepare=lambda: None,
                 cold: bool = True) -> float:
    """Median CUDA-event ms of one call of fn with the L2 cache flushed
    before it (a 256 MB fill; cold=False leaves it warm), then a ~2 ms
    device sleep that holds the stream while the host enqueues fn, so the
    events time fn's kernels alone, not the host's launch cost. prepare()
    runs before the flush, outside the timed window: a kernel that updates
    its inputs in place restores them there."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    prepare()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        prepare()
        if cold:
            flush.zero_()
        torch.cuda._sleep(4_000_000)  # cycles: ~2 ms at the H100's clocks
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(torch, fn, calls: int = 100) -> float:
    """Host microseconds per call of fn over `calls` calls enqueued with no
    synchronisation between them: the wrapper's own cost (checks,
    allocations, the launch), as long as fewer launches than the stream's
    queue holds are pending."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


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


def profile_second_iteration(torch, rend):
    """Profile iteration 2 of a 2-iteration render of `rend` (PPMRenderer),
    opened and closed at two checkpoint_cb ticks, so that no per-render
    set-up falls inside the window. Returns (profile, the iteration's wall
    ms, the render's image sum)."""
    prof = profiler()
    window = {}

    def tick(i, img_sum):
        torch.cuda.synchronize()
        if i == 0:
            prof.start()
            window["t0"] = time.perf_counter()
        elif i == 1:
            window["ms"] = (time.perf_counter() - window["t0"]) * 1e3
            prof.stop()

    rend.iterations = 2
    img_sum = rend.render(checkpoint_cb=tick)
    return prof, window["ms"], img_sum


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


def launch_ms(prof, name: str) -> list:
    """Device ms of each launch of the kernels whose name holds `name` in a
    profile, in launch order."""
    from torch.autograd import DeviceType
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA and name in e.name),
                    key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in events]


def kernel_ms(per: dict, name: str) -> float:
    return sum(ms for key, ms in per.items() if name in key)


def device_ms_field(per: dict, name: str) -> str:
    """A kernel's device ms per call for a phase line. Late in a long
    process the profiler now and then records no device event at all in a
    window that holds only ctypes-launched kernels (seen for the mesh
    kernels): that reads "not_seen", and the CUDA-event ms stands."""
    return (f"{kernel_ms(per, name):.4f}" if any(name in k for k in per)
            else "not_seen")


def png_size(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        head = f.read(24)
    require(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR",
            f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


# {compare's name: the kernel's device ms per call in its last profile, or
# None where the profile recorded none of its events}
KERNEL_DEVICE_MS = {}


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
    KERNEL_DEVICE_MS[name] = (kernel_ms(per, kernel)
                              if any(kernel in k for k in per) else None)
    phase(name, shape=what, equal=exact, max_abs_err=err, ms=f"{kms:.4f}",
          plain_ms=f"{pms:.4f}", device_ms=device_ms_field(per, kernel),
          wrapper_device_ms=f"{sum(per.values()):.4f}",
          plain_device_ms=f"{pdev:.4f}", **fields)
    require(exact, f"{name} ({what}): the kernel differs from its plain "
            f"version (max abs {err})")
    return err, kms, pms, want


def tri_skips(torch, tk, table, org, d, alive) -> dict:
    """The triangle kernel's skips on these rays (tri_pair_stages, the plain
    emulation, on the card): the real columns, the live pairs (those of the
    rays of live 1024-ray blocks), how many leave at each of the kernel's
    stages, those accepted, and `ops`: each pair's float32 operations up to
    where it leaves (OPS), the operation count of the kernel's bound.
    Requires that no skipped pair is accepted."""
    real = torch.nonzero((table[3:9] != 0).any(dim=0)).flatten()
    live = alive.reshape(-1, 1024).any(dim=1).repeat_interleave(1024)
    stage, accepted = tk.tri_pair_stages(table[:, real], org[live], d[live])
    require(not bool(((stage != tk.FULL) & accepted).any()),
            "intersect_tris: the pre-reject skips an accepted pair")
    at = [int((stage == k).sum()) for k in (tk.AT_DET, tk.AT_U, tk.AT_VT,
                                             tk.FULL)]
    ops = sum(n * OPS[k] for n, k in zip(at, ("tri_det", "tri_u", "tri_vt",
                                              "tri")))
    return dict(real_columns=real.numel(), live_pairs=stage.numel(),
                left_at_det=at[0], left_at_u=at[1], left_at_vt=at[2],
                full_tests=at[3], accepted_pairs=int(accepted.sum()),
                ops=ops)


def no_path_kernels() -> dict:
    """The wrappers of the kernels that no render of phases 4-14 calls, by
    name: the clustered sphere kernel and the raster gather, which no
    renderer calls, and the BVH4 walk, which only a mesh on the BVH4 table
    takes (phase 15). Each main-path render of phases 4-14 sets their
    counts to 0 just before it, with its own, and reads them just after
    (read_no_path)."""
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bwk
    from pathtracer_tpu_torch.ops.cuda import gather_kernel as gk
    from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk
    return {"intersect_clustered": sk.intersect_clustered,
            "gather_flux": gk.gather_flux, "bvh4_walk": bwk.bvh4_walk}


# {render path: {no-path kernel: launches in that render}}
NO_PATH_LAUNCHES = {}
# phases 11 and 13's walls (the BVH8 walk), beside phase 15's (the BVH4)
MESH_WALLS = {}


def read_no_path(path: str, launches: dict) -> None:
    """Move the no-path kernels' counts out of one render's `launches` into
    NO_PATH_LAUNCHES[path]."""
    NO_PATH_LAUNCHES[path] = {k: launches.pop(k) for k in no_path_kernels()}


def path_kernels() -> dict:
    """The launch-counted wrappers of the nine kernels on the
    multi-device paths (phase 14), by name."""
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bwk
    from pathtracer_tpu_torch.ops.cuda import compact_kernel as ck
    from pathtracer_tpu_torch.ops.cuda import fused_bounce_kernel as fbk
    from pathtracer_tpu_torch.ops.cuda import gather_kernel as gk
    from pathtracer_tpu_torch.ops.cuda import mesh_bounce_kernel as mbk
    from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk
    from pathtracer_tpu_torch.ops.cuda import tri_kernel as tk
    return {"fused_bounce": fbk.fused_bounce,
            "compact_blocks": ck.compact_blocks,
            "intersect_spheres": sk.intersect_spheres,
            "intersect_tris": tk.intersect_tris,
            "gather_flux_chunks": gk.gather_flux_chunks,
            "intersect_tile_tris": ttk.intersect_tile_tris,
            "bvh8_walk": bwk.bvh8_walk, "winner_t": mbk.winner_t,
            "mesh_bounce": mbk.mesh_bounce}


def counted(torch, dev, fn):
    """(fn()'s result, launches by kernel of path_kernels and
    no_path_kernels, wall seconds) of one call, the counts set to 0 just
    before it and read just after."""
    counters = {**path_kernels(), **no_path_kernels()}
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return out, {k: f.launches for k, f in counters.items()}, wall


def ring_hop_ms(torch, dev, rows: int):
    """Median ms of 5 timed (after one warm) group.ring_shift calls over
    the default group of a sub-grid of `rows` deposits, of
    build_photon_chunks' shapes: (16, Np_pad) and (6, Np_pad / 32) f32."""
    import torch.distributed as dist

    from pathtracer_tpu_torch.parallel import group

    np_pad = -(-rows // 128) * 128
    grid = (torch.zeros(16, np_pad, device=dev),
            torch.zeros(6, np_pad // 32, device=dev))
    times = [counted(torch, dev, lambda: group.ring_shift(
        grid, dist.group.WORLD))[2] * 1e3 for _ in range(6)]
    return sorted(times[1:])[2]


def rank_runs(dev, jobs) -> list:
    """Phase 14b's entry point on each spawned rank
    (group.spawn("chip_smoke:rank_runs", ...)): each job of kind "pt" is
    parallel.ranks.sharded_pt's render, run job["renders"] times; each of
    kind "ppm" one render of parallel.ranks.ppm_renderer's, then
    ring_hop_ms at its deposit rows. Returns per job the (last) image on
    the CPU, its segments or photon map lengths, and every rank's deposit
    rows, launches of the last render, walls and hop ms."""
    import torch
    import torch.distributed as dist
    from pathtracer_tpu_torch.parallel import ranks

    def every(obj):
        objs = [None] * dist.get_world_size()
        dist.all_gather_object(objs, obj)
        return objs

    out = []
    for job in jobs:
        if job["kind"] == "pt":
            render, walls = ranks.sharded_pt(dev, job), []
            for _ in range(job["renders"]):
                (img, segs), launches, wall = counted(torch, dev, render)
                walls.append(wall)
            res = dict(segments=segs)
        else:
            rend = ranks.ppm_renderer(dev, job)
            img, launches, wall = counted(torch, dev, rend.render)
            walls = wall
            res = dict(photon_map_lengths=[int(n) for n in
                                           rend.photon_map_lengths],
                       deposit_rows=every(rend.deposit_rows),
                       hop_ms=every(ring_hop_ms(torch, dev,
                                                rend.deposit_rows)))
        out.append(dict(res, img=img.cpu(), launches=every(launches),
                        walls=every(walls)))
    return out


def gather_walk(torch, gk, pt, act, lists, counts, sbox, radius):
    """The chunk gather's listed entries (block, list position) on
    Morton-sorted hits and their block lists: (blk, kpos, chunk, listed
    (entries, N_SUBS) bool, the sub-chunks each entry's mask lists, walked
    (entries, N_SUBS) int64, the active hits of the warps that walk each
    listed sub-chunk: those whose active-hit box, grown by the padded
    radius, meets the sub-chunk's box)."""
    dev = pt.device
    nblk = counts.shape[0]
    live = torch.arange(lists.shape[1], device=dev)[None, :] \
        < counts[:, None]
    blk, kpos = torch.nonzero(live, as_tuple=True)
    words = lists[blk, kpos].long() & 0xFFFFFFFF
    chunk = words & ((1 << gk.MASK_SHIFT) - 1)
    mask = words >> gk.MASK_SHIFT
    r_pad = float(gk._radius_f32(radius)[3])
    warp_act = act.reshape(nblk, 32, 32)
    warp_pt = pt.reshape(nblk, 32, 32, 3)
    lo = torch.where(warp_act[..., None], warp_pt, gk.BIG).amin(2) - r_pad
    hi = torch.where(warp_act[..., None], warp_pt, -gk.BIG).amax(2) + r_pad
    warp_n = warp_act.sum(2)  # (nblk, 32) active hits per warp
    listed, walked = [], []
    for t in range(gk.N_SUBS):
        on = ((mask >> t) & 1).bool()
        box = sbox[:, chunk * gk.N_SUBS + t]
        meets = on[:, None].expand(-1, 32).clone()
        for ax in range(3):
            meets &= (box[3 + ax][:, None] >= lo[blk, :, ax]) \
                & (box[ax][:, None] <= hi[blk, :, ax])
        listed.append(on)
        walked.append((meets * warp_n[blk]).sum(1))
    return blk, kpos, chunk, torch.stack(listed, 1), torch.stack(walked, 1)


def gather_work(torch, gk, act, counts, walk):
    """The chunk gather's work from gather_walk's `walk`: the items
    (segments of SEG list positions), the hit-photon pairs the lists hold
    (each active hit of a block x the photons of its listed sub-chunks) and
    those the kernel's warps walk, and the heaviest item's sub-chunks and
    pairs."""
    blk, kpos, _, listed, walked = walk
    dev = act.device
    item_start = gk.block_items(counts).long()
    n_items = int(item_start[-1])
    item = item_start[blk] + kpos // gk.SEG
    blk_n = act.reshape(counts.shape[0], 1024).sum(1)
    subs = listed.sum(1)
    item_subs = torch.zeros(n_items, dtype=torch.int64, device=dev) \
        .index_add_(0, item, subs)
    item_pairs = torch.zeros(n_items, dtype=torch.int64, device=dev) \
        .index_add_(0, item, subs * blk_n[blk]) * gk.SUB
    per_block = item_start[1:] - item_start[:-1]
    return dict(items=n_items, items_per_block_max=int(per_block.max()),
                item_subchunks_max=int(item_subs.max()),
                item_pairs_max=int(item_pairs.max()),
                entries=int(blk.numel()),
                listed_pairs=int((subs * blk_n[blk]).sum()) * gk.SUB,
                walked_pairs=int(walked.sum()) * gk.SUB)


def timed_host_read(torch, gk, waits: list):
    """Wrap gk.block_items so that each gather also records, in `waits`,
    the host's wait (ms) for the device at the point where the wrapper
    reads the item count: what that read costs the caller. Returns the
    function to restore."""
    items = gk.block_items

    def wrapped(counts):
        out = items(counts)
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        waits.append((time.perf_counter() - t0) * 1e3)
        return out

    gk.block_items = wrapped
    return items


def listed_pairs(torch, r, state):
    """Ray-sphere pairs of a listed bounce-0 sphere loop over `state`: each
    live ray against its block's distinct list entries (a list is padded
    with repeats of its first)."""
    live_blk = (state[9] > 0).reshape(-1, 1024).sum(dim=1)
    n_list = torch.tensor([len(set(row[:c].tolist())) for row, c in zip(
        r.lists.cpu(), r.counts[:, 0].tolist())], device=state.device)
    return int((live_blk * n_list).sum())


def cull_work(torch, r, hier, state, n_sph):
    """The full-variant sphere loop's work on `state` under the per-warp
    walk of `hier`, from its plain emulation
    (sphere_kernel.intersect_culled_plain), which must give intersect_regs'
    result on every live lane: per warp with a live lane, the nodes visited
    and the leaves entered; the pairs tested (each live lane against the
    unconditional spheres and the spheres of its warp's entered leaves)
    beside the brute force's; the operations of both and the hierarchy's
    bytes; and fused_bounce's bound of both (bytes: state, radiance and
    offsets in and out, and the tables). The kernel's bound is the one
    under the walk: the work these inputs need."""
    from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk

    comps = [state[c].reshape(-1) for c in range(6)]
    alive = state[9].reshape(-1) > 0
    at, idx, st = sk.intersect_culled_plain(r.sph_table, hier, *comps, alive,
                                            origin_zero=False)
    want = sk.intersect_regs(r.sph_table, *comps, origin_zero=False)
    require(torch.equal(at[alive], want[0][alive])
            and torch.equal(idx[alive], want[1][alive]),
            "the walk's plain emulation differs from intersect_regs")
    live_w = st["live_lanes"]
    w = live_w > 0
    pairs = int((live_w * st["spheres_tested"]).sum())
    node_tests = int((live_w * st["nodes_visited"]).sum())
    n_live = int(alive.sum())
    n_bytes = (state.shape[1] * state.shape[2] * 4 * (10 + 3 + 1 + 10 + 3)
               + (r.sph_table.numel() + r.pack_table.numel()) * 4)
    tree_bytes = (hier.order.numel() + hier.nodes.numel()
                  + hier.links.numel()) * 4
    ops_brute = n_live * n_sph * OPS["fused_sphere"]
    ops = pairs * OPS["fused_sphere"] + node_tests * OPS["sphere_node"]
    return dict(
        leaves_mean=float(st["leaves_entered"][w].float().mean()),
        leaves_max=int(st["leaves_entered"].max()),
        nodes_mean=float(st["nodes_visited"][w].float().mean()),
        nodes_max=int(st["nodes_visited"].max()),
        pairs=pairs, pairs_brute=n_live * n_sph, node_tests=node_tests,
        ops=ops, ops_brute=ops_brute, tree_bytes=tree_bytes,
        bound_brute=bound(n_bytes, ops_brute),
        bound_culled=bound(n_bytes + tree_bytes, ops))


def two_kernel_kernels(torch, r, hier, fb_in, off, bg, n_sph):
    """Phase 3, second half: intersect_state and shade_state against their
    plain versions at bounce 0 (listed, origin-zero) and bounce 1 (full),
    and the chain of the two kernels against fused_bounce; all equal.
    Returns {bounce: (intersect (err, ms, plain_ms), its bound, shade
    (err, ms, plain_ms), its bound)}."""
    from pathtracer_tpu_torch.ops.cuda import fused_bounce_kernel as fbk
    from pathtracer_tpu_torch.ops.cuda import shade_kernel as shk
    from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk

    bg_mode, colors = bg
    out = {}
    for b, listed in ((0, True), (1, False)):
        state = fb_in[b]
        n = state.shape[1] * state.shape[2]
        kw = dict(origin_zero=b == 0,
                  block_lists=(r.lists, r.counts) if listed else None,
                  sphere_bvh=None if listed else hier)
        limbs = r.sampler.limbs(2 + 2 * b, 3 + 2 * b)
        rad0 = torch.zeros(3, *state.shape[1:], device=state.device)
        what = f"bounce{b}_{'listed' if listed else 'full'}:{n}_lanes"
        earlier = {} if listed else {
            "before_cull_device_ms": BEFORE_CULL_MS["intersect_state"]}
        i_res = compare(
            torch, "intersect_state",
            lambda: sk.intersect_state(r.sph_table, state, **kw),
            lambda: sk.intersect_state_plain(r.sph_table, state, **kw),
            what, kernel="intersect_state_kernel", **earlier)[:3]
        at, idx = sk.intersect_state(r.sph_table, state, **kw)
        args = (state, r.pack_table, idx, off, at, limbs, colors, rad0)
        s_res = compare(
            torch, "shade_state",
            lambda: shk.shade_state(*args, bg_mode=bg_mode),
            lambda: shk.shade_state_plain(*args, bg_mode=bg_mode), what,
            kernel="shade_kernel")[:3]
        chain = shk.shade_state(*args, bg_mode=bg_mode)
        fused = fbk.fused_bounce(r.sph_table, state, r.pack_table, off,
                                 limbs, colors, rad0, bg_mode=bg_mode, **kw)
        torch.cuda.synchronize()
        equal = all(torch.equal(c, f) for c, f in zip(chain, fused))
        # the two kernels' device time with their inputs out of L2 (the
        # bytes bound assumes them in device memory)
        cold = (time_cold_ms(torch, lambda: sk.intersect_state(
                    r.sph_table, state, **kw)),
                time_cold_ms(torch, lambda: shk.shade_state(
                    *args, bg_mode=bg_mode)))
        # the host's cost of each wrapper call, which a render pays per
        # bounce: one fused call against the two of the two-kernel bounce
        host = {"intersect_state": host_us(torch, lambda: sk.intersect_state(
                    r.sph_table, state, **kw)),
                "shade_state": host_us(torch, lambda: shk.shade_state(
                    *args, bg_mode=bg_mode)),
                "fused_bounce": host_us(torch, lambda: fbk.fused_bounce(
                    r.sph_table, state, r.pack_table, off, limbs, colors,
                    rad0, bg_mode=bg_mode, **kw))}
        phase("two_kernel_chain", shape=what, equal_to_fused_bounce=equal,
              intersect_state_cold_l2_ms=f"{cold[0]:.4f}",
              shade_state_cold_l2_ms=f"{cold[1]:.4f}",
              host_us_per_call=json.dumps({k: round(v, 2)
                                           for k, v in host.items()}))
        require(equal, f"bounce {b}: intersect_state -> shade_state differs "
                "from fused_bounce")
        # bytes: intersect_state reads the origin, direction and alive
        # planes and writes (at, idx); shade_state reads the state, the
        # radiance, at, idx and the offsets and writes state and radiance
        live = state[9] > 0
        n_live = int(live.sum())
        n_hit = int(((at < sk.BIG) & live).sum())
        i_bytes = n * 4 * (7 + 2) + r.sph_table.numel() * 4
        if listed:
            i_bound = bound(i_bytes + r.lists.numel() * 4,
                            listed_pairs(torch, r, state)
                            * OPS["listed_sphere"])
        else:  # the work under the walk; the brute force's beside it
            c = cull_work(torch, r, hier, state, n_sph)
            i_bound = bound(i_bytes + c["tree_bytes"], c["ops"])
            i_bound["bound_ms_brute"] = bound(i_bytes,
                                              c["ops_brute"])["bound_ms"]
        s_bound = bound(n * 4 * (16 + 13) + r.pack_table.numel() * 4,
                        n_hit * OPS["shade"]
                        + (n_live - n_hit) * OPS["shade_miss"])
        out[b] = (i_res, dict(i_bound, device_ms_cold_l2=cold[0]), s_res,
                  dict(s_bound, device_ms_cold_l2=cold[1]))
    return out


def two_kernel_render(torch, np, make_render_fn, scene, cam, bg, dev,
                      fused_img, fused_segments, fused_render, smi):
    """Phase 4b: the canonical render with fuse_bounce=False. Its warm
    walls are taken alternately with the fused render's (fused_render) in
    this phase, so both see the same host. Returns the two kernels' launch
    counts."""
    from pathtracer_tpu_torch.ops.cuda import fused_bounce_kernel as fbk
    from pathtracer_tpu_torch.ops.cuda import shade_kernel as shk
    from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk

    render = make_render_fn(cam, bg, WIDTH, HEIGHT, SPP, BOUNCES, dev,
                            fuse_bounce=False)
    render(scene)  # warm-up
    counters = {"intersect_state": sk.intersect_state,
                "shade_state": shk.shade_state,
                "fused_bounce": fbk.fused_bounce, **no_path_kernels()}
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    img, segments = render(scene)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    read_no_path("shirley_two_kernel", launches)
    walls = {"fused": [], "two_kernel": []}
    for order in (("fused", "two_kernel"), ("two_kernel", "fused")) * 3:
        for name in order:
            fn = fused_render if name == "fused" else render
            t0 = time.perf_counter()
            fn(scene)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    equal = torch.equal(img, fused_img)
    oracle = np.load(ORACLE)["img"]
    rmse = float(np.sqrt(np.mean((img.cpu().numpy().astype(np.float64)
                                  - oracle) ** 2)))
    busy_ms, per, n_ops, prof_wall_ms = device_times(
        torch, lambda: render(scene), reps=1)
    phase("two_kernel_render", config=f"{WIDTH}x{HEIGHT},spp={SPP},"
          f"b={BOUNCES},fuse_bounce=False", segments=segments,
          fused_segments=fused_segments, image_equal_to_fused=equal,
          rmse=f"{rmse:.6e}",
          wall_s=f"{statistics.median(walls['two_kernel']):.4f}",
          fused_wall_s=f"{statistics.median(walls['fused']):.4f}",
          walls_s=json.dumps([round(w, 4) for w in walls["two_kernel"]]),
          fused_walls_s=json.dumps([round(w, 4) for w in walls["fused"]]),
          launches=json.dumps(launches),
          profiled_wall_ms=f"{prof_wall_ms:.3f}",
          device_busy_ms=f"{busy_ms:.3f}",
          device_idle_share=f"{1 - busy_ms / prof_wall_ms:.3f}",
          intersect_state_ms=f"{kernel_ms(per, 'intersect_state_kernel'):.3f}",
          shade_ms=f"{kernel_ms(per, 'shade_kernel'):.3f}",
          device_ops=f"{n_ops:.0f}", gpu=json.dumps(smi))
    require(launches["intersect_state"] > 0 and launches["shade_state"] > 0
            and launches["fused_bounce"] == 0,
            f"the two-kernel render's launches: {launches}")
    require(segments == fused_segments,
            f"two-kernel segments {segments} vs fused {fused_segments}")
    require(equal, "the two-kernel image differs from the fused image")
    require(rmse < RMSE_BUDGET, f"two-kernel RMSE {rmse} >= {RMSE_BUDGET}")
    return launches


def clustered_work(torch, tables, org, d, alive, n_valid):
    """The operations intersect_clustered's function needs on these rays.
    The cull of each live lane against every cluster (the kernel's float
    tests, any-reduced over each 1024-ray block as its plain version does),
    then each live lane of a block against the real (unpadded) spheres of
    the clusters that survived; beside it the brute force, each live lane
    against every valid sphere."""
    from pathtracer_tpu_torch.ops import vec
    from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk

    sph, clus, _ = tables
    k = clus.shape[1]
    e0, e1, e2 = (d[:, c, None] for c in range(3))
    a = e0 * e0 + e1 * e1 + e2 * e2
    fx, fy, fz = (clus[c][None, :] - org[:, c, None] for c in range(3))
    fb = fx * e0 + fy * e1 + fz * e2  # (n, K)
    fq = fx * fx + fy * fy + fz * fz
    cr2 = clus[3][None, :]
    may_hit = ((((fq - fb * fb * (1.0 / a)) <= cr2) | (fq <= cr2))
               & (fb >= -vec.sqrt(cr2 * a)) & alive[:, None])
    run = may_hit.reshape(-1, 1024, k).any(dim=1)  # (blocks, K)
    live = alive.reshape(-1, 1024).sum(dim=1)
    real = (sph[3].reshape(k, sk.CLUSTER) != -sk.BIG).sum(dim=1)
    sphere_tests = int((live[:, None] * run * real[None, :]).sum())
    n_live = int(alive.sum())
    return {"tested_block_clusters": int(run.sum()),
            "live_blocks": int((live > 0).sum()),
            "real_spheres": int(real.sum()),
            "live_sphere_tests": sphere_tests,
            "clustered_ops": n_live * k * OPS["cull"]
            + sphere_tests * OPS["sphere"],
            "brute_force_ops": n_live * n_valid * OPS["sphere"]}


def clustered_walk_work(torch, tables, walk, org, d, alive, want) -> dict:
    """The redesigned kernel's walk on these rays, from its plain emulation
    (sphere_kernel.intersect_clustered_walk_plain), which must equal the
    plain version's outputs `want`: the surviving clusters of each live
    block, the clusters each warp of a live block enters and the real pairs
    each of its lanes tests (mean and max), the lanes outside the warp
    skip's proof, and the walked work: each live lane's grown-bound tests
    (its block's surviving clusters) and real pairs (its warp's)."""
    from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk

    *got, st = sk.intersect_clustered_walk_plain(tables, walk, org, d, alive)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "the clustered walk's plain emulation differs from "
            "intersect_clustered_plain")
    live_blk = alive.reshape(-1, 1024).any(dim=1)
    warps = live_blk.repeat_interleave(1024 // sk.WARP)
    live_w = alive.reshape(-1, sk.WARP).sum(dim=1)
    surv_w = st["surviving"].repeat_interleave(1024 // sk.WARP)
    node_tests = int((live_w * surv_w).sum())
    pairs = int((live_w * st["pairs"]).sum())
    ent, prs, surv = (st["entered"][warps].float(), st["pairs"][warps],
                      st["surviving"][live_blk].float())
    return dict(
        surviving_per_block_mean=round(float(surv.mean()), 3),
        surviving_per_block_max=int(surv.max()),
        entered_per_warp_mean=round(float(ent.mean()), 3),
        entered_per_warp_max=int(ent.max()),
        pairs_per_lane_mean=round(float(prs.float().mean()), 3),
        pairs_per_lane_max=int(prs.max()),
        uncovered_lanes=int(st["uncovered"].sum()),
        walked_bound_tests=node_tests, walked_pairs=pairs,
        walked_ops=node_tests * OPS["sphere_node"] + pairs * OPS["sphere"])


def clustered_phase(torch, scene, sph_table, state):
    """Phase 4c: intersect_clustered on the rays of the bounce-1 `state`
    against its plain version and its walk, then against
    intersect_spheres. Returns (err, ms, plain_ms, bound dict with the
    three bounds, intersect_spheres ms, the kernel's device ms)."""
    from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk

    t0 = time.perf_counter()
    tables = sk.pack_spheres_clustered(scene.center, scene.radius,
                                       scene.valid)
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    walk = sk.cached_cluster_walk(tables)  # the one the wrapper reads
    walk_ms = (time.perf_counter() - t0) * 1e3
    org = state[0:3].reshape(3, -1).T.contiguous()
    d = state[3:6].reshape(3, -1).T.contiguous()
    alive = state[9].reshape(-1) > 0
    n, k = org.shape[0], tables[1].shape[1]
    work = clustered_work(torch, tables, org, d, alive,
                          int(scene.valid.sum()))
    err, kms, pms, want = compare(
        torch, "intersect_clustered",
        lambda: sk.intersect_clustered(tables, org, d, alive),
        lambda: sk.intersect_clustered_plain(tables, org, d, alive),
        f"bounce1:{n}_rays", kernel="intersect_clustered_kernel",
        plain_reps=1, plain_batch=1, plain_prof=1, clusters=k,
        pack_s=f"{pack_s:.3f}", walk_ms=f"{walk_ms:.3f}",
        real_slots=walk.n_real, of_block_clusters=n // 1024 * k,
        before_redesign_device_ms=BEFORE_CLUSTERED_MS["device"],
        before_redesign_ms=BEFORE_CLUSTERED_MS["events"], **work)
    dev_ms = KERNEL_DEVICE_MS["intersect_clustered"]
    walked = clustered_walk_work(torch, tables, walk, org, d, alive, want)
    # bytes: the rays, alive and the outputs, the tables and the walk's;
    # operations: the block cull's work, the walked work, the brute force
    # (each the function's work by one method); the bound is the least
    n_bytes = (n * (24 + 1 + 12) + sum(t.numel() * 4 for t in tables)
               + (walk.runs.numel() + walk.bounds.numel()) * 4)
    three = {"block_cull": work["clustered_ops"],
             "walked": walked["walked_ops"],
             "brute": work["brute_force_ops"]}
    bounds = {name: bound(n_bytes, ops) for name, ops in three.items()}
    c_bound = dict(min(bounds.values(), key=lambda b: b["bound_ms"]),
                   **{f"bound_ms_{name}": b["bound_ms"]
                      for name, b in bounds.items()})
    phase("clustered_walk", **walked,
          **{f"bound_ms_{name}": f"{b['bound_ms']:.4f}"
             for name, b in bounds.items()})
    ones = torch.ones_like(alive)
    mism = {}
    for label, mask in (("live", alive), ("all_alive", ones)):
        got = sk.intersect_clustered(tables, org, d, mask)
        want_s = sk.intersect_spheres(sph_table, org, d, mask)
        lanes = mask if label == "live" else ones
        hit_eq = torch.equal(got[2][lanes], want_s[2][lanes])
        at_eq = torch.equal(got[0][lanes], want_s[0][lanes])
        idx_ne = lanes & got[2] & (got[1] != want_s[1])
        mism[label] = (hit_eq, at_eq, int(idx_ne.sum()))
    s_ms = time_ms(torch, lambda: sk.intersect_spheres(sph_table, org, d,
                                                       alive))
    _, per, _, _ = device_times(torch, lambda: sk.intersect_spheres(
        sph_table, org, d, alive), reps=5)
    phase("clustered_vs_spheres", rays=n, live=int(alive.sum()),
          hit_equal_live=mism["live"][0], at_equal_live=mism["live"][1],
          idx_mismatches_live=mism["live"][2],
          hit_equal_all_alive=mism["all_alive"][0],
          at_equal_all_alive=mism["all_alive"][1],
          idx_mismatches_all_alive=mism["all_alive"][2],
          clustered_ms=f"{kms:.4f}", intersect_spheres_ms=f"{s_ms:.4f}",
          intersect_spheres_device_ms=device_ms_field(
              per, "intersect_spheres_kernel"),
          bound_ms=f"{c_bound['bound_ms']:.4f}")
    require(all(h and a for h, a, _ in mism.values()),
            f"intersect_clustered's hits differ from intersect_spheres': "
            f"{mism}")
    return err, kms, pms, c_bound, s_ms, dev_ms


def raster_design_readings(torch, gk, args, want) -> dict:
    """CUDA-event ms of the raster gather's kernel alone (its C entry point,
    without the wrapper's glue) on args, as shipped and with each of its
    design choices undone: every warp walked in batches (HEAVY = 0), none
    (HEAVY past every lane), and the warps in index order (Morton order of
    the hits) instead of longest first. Each must equal want."""
    from pathtracer_tpu_torch import _build
    point, normal, s, e, photons_t, r = args
    n = point.shape[0]
    hits = torch.cat([point.T, normal.T]).contiguous()
    longest = gk.warp_order(s, e)
    morton = torch.arange(n // 32, dtype=torch.int32, device=point.device)
    out = torch.empty(3, n, dtype=torch.float32, device=point.device)
    stream = torch.cuda.current_stream(point.device).cuda_stream
    lib = _build.load()
    ways = {"shipped": (gk.HEAVY, longest), "all_batched": (0, longest),
            "none_batched": (2 ** 31 - 1, longest),
            "morton_order": (gk.HEAVY, morton)}
    res = {}
    for name, (heavy, order) in ways.items():
        def launch(heavy=heavy, order=order):
            _build.check(lib, lib.pt_gather_flux(
                hits.data_ptr(), s.data_ptr(), e.data_ptr(),
                photons_t.data_ptr(), photons_t.shape[1],
                float(gk._radius_f32(r)[0]), order.data_ptr(), heavy,
                out.data_ptr(), n, stream), "gather_flux")
        launch()
        torch.cuda.synchronize()
        require(torch.equal(out.T, want), f"gather_flux ({name}) differs "
                "from the wrapper's result")
        res[f"{name}_kernel_ms"] = f"{time_ms(torch, launch):.4f}"
    return res


def raster_gather_phase(torch, np, deposits, hits, r1, chunks):
    """Phase 6, the raster-grid gather on cornell iteration 1's deposits
    and eye hits at r(1). Returns its JSON entry (without launches)."""
    from pathtracer_tpu_torch import ppm
    from pathtracer_tpu_torch.ops.cuda import gather_kernel as gk

    t0 = time.perf_counter()
    photons_t, start, count, glo, cell = ppm._build_grid_morton_device(
        *deposits, r1)
    pt, nm, act = hits
    s, e, own = gk.query_tables(pt, act, glo, cell, start, count)
    perm = torch.argsort(own, stable=True)
    pt, nm, act = pt[perm].contiguous(), nm[perm].contiguous(), act[perm]
    s, e = s[:, perm].contiguous(), e[:, perm].contiguous()
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    n = pt.shape[0]
    nblk = n // 1024
    lane_len = (e - s).sum(dim=0)
    blk_len = lane_len.reshape(nblk, 1024).amax(dim=1)
    longest = torch.argsort(blk_len, descending=True, stable=True)[
        :RASTER_LONGEST].tolist()
    spaced = [b for b in np.linspace(0, nblk - 1, RASTER_SPACED + 8)
              .round().astype(int).tolist() if b not in longest]
    blocks = sorted(longest + spaced[:RASTER_SPACED])
    rows = torch.cat([torch.arange(b * 1024, (b + 1) * 1024,
                                   device=pt.device) for b in blocks])
    sub = (pt[rows].contiguous(), nm[rows].contiguous(),
           s[:, rows].contiguous(), e[:, rows].contiguous(), photons_t, r1)
    err, ms_sub, plain_ms, (want_rows,) = compare(
        torch, "gather_flux", lambda: gk.gather_flux(*sub),
        lambda: gk.gather_flux_plain(*sub),
        f"{len(blocks)}_of_{nblk}_blocks", kernel="gather_flux_kernel",
        plain_reps=1, plain_batch=1, plain_prof=1,
        lane_range_max=int(lane_len[rows].max()),
        block_range_max=json.dumps(blk_len[blocks].tolist()))
    args = (pt, nm, s, e, photons_t, r1)
    full = gk.gather_flux(*args)
    torch.cuda.synchronize()
    require(torch.equal(full[rows], want_rows),
            "the full-size raster gather differs from the plain version on "
            "the checked blocks")
    photons_c, sbox = chunks
    chunk = gk.gather_flux_chunks(pt, nm, act, sbox, photons_c, r1)
    diff = (full - chunk).abs()
    rel = float((diff / chunk.abs().clamp(min=1e-30)).max())
    close = bool((diff <= 1e-6 + 1e-4 * chunk.abs()).all())
    # what sets the time: the longest lane's pairs, its block alone, and
    # how much of each warp's walk its longest lane holds (the warp runs
    # until that lane ends)
    top = int(torch.argmax(blk_len))
    blk = slice(top * 1024, (top + 1) * 1024)
    one = (pt[blk].contiguous(), nm[blk].contiguous(),
           s[:, blk].contiguous(), e[:, blk].contiguous(), photons_t, r1)
    top_ms = time_ms(torch, lambda: gk.gather_flux(*one))
    _, per_top, _, _ = device_times(torch, lambda: gk.gather_flux(*one),
                                    reps=5)
    warp_max = lane_len.reshape(-1, 32).amax(dim=1)
    # distinct nonempty ranges among a warp's lanes, per offset: the
    # photons a warp's load of one position touches
    key = torch.where(e > s, s.long() * (1 << 31) + e.long(), -1)
    key = torch.sort(key.reshape(9, -1, 32), dim=2).values
    distinct = ((key[:, :, 1:] != key[:, :, :-1]) & (key[:, :, 1:] >= 0)
                ).sum(dim=2) + (key[:, :, 0] >= 0)
    nonempty = (key >= 0).any(dim=2)
    lane_max = int(lane_len.max())
    measure = dict(
        lane_range_max=lane_max,
        single_range_max=int((e - s).max()),
        lanes_over_4096=int((lane_len > 4096).sum()),
        lanes_over_16384=int((lane_len > 16384).sum()),
        pairs_over_warp_max_x32=f"{float(lane_len.sum()) / float(warp_max.sum() * 32):.4f}",
        warp_distinct_ranges=f"{float(distinct[nonempty].float().mean()):.2f}",
        longest_block_warp_distinct_ranges=f"{float(distinct[:, top * 32:(top + 1) * 32][nonempty[:, top * 32:(top + 1) * 32]].float().mean()):.2f}",
        longest_block=top, longest_block_ms=f"{top_ms:.4f}",
        longest_block_device_ms=device_ms_field(per_top,
                                                "gather_flux_kernel"),
        longest_block_pairs=int(lane_len[blk].sum()),
        ns_per_pair_longest_lane=f"{top_ms * 1e6 / max(lane_max, 1):.3f}")
    ms = time_ms(torch, lambda: gk.gather_flux(*args))
    chunk_ms = time_ms(torch, lambda: gk.gather_flux_chunks(
        pt, nm, act, sbox, photons_c, r1))
    _, per, _, _ = device_times(torch, lambda: gk.gather_flux(*args), reps=5)
    cold_ms = time_cold_ms(torch, lambda: gk.gather_flux(*args))
    measure.update(raster_design_readings(torch, gk, args, full))
    # work: every hit-photon pair of the lanes' ranges, counted up to where
    # a walk must take it (raster_pair_counts); bytes: the hits, the
    # ranges, the output and each photon that some range holds, once
    np_pad = photons_t.shape[1]
    cover = torch.zeros(np_pad + 1, dtype=torch.int64, device=pt.device)
    cover.index_add_(0, s.reshape(-1).long(), torch.ones_like(
        s.reshape(-1), dtype=torch.int64))
    cover.index_add_(0, e.reshape(-1).long(), -torch.ones_like(
        e.reshape(-1), dtype=torch.int64))
    covered = int((torch.cumsum(cover, 0)[:np_pad] > 0).sum())
    pairs, near, adding = gk.raster_pair_counts(*args)
    require(pairs == int(lane_len.sum()), "raster_pair_counts: "
            f"{pairs} pairs, the ranges hold {int(lane_len.sum())}")
    g_bound = bound(n * (24 + 72 + 12) + covered * 36,
                    (pairs - near) * OPS["gather_far"]
                    + (near - adding) * OPS["gather_near"]
                    + adding * OPS["gather"])
    phase("gather_flux_full", hits=n, blocks=nblk,
          photon_columns=np_pad, radius=f"{r1:.6f}",
          cell=f"{float(cell):.6f}", cell_over_r=f"{float(cell) / r1:.3f}",
          grid_s=f"{grid_s:.3f}", pairs=pairs, pairs_inside_r=near,
          pairs_adding=adding, photons_in_ranges=covered,
          lane_range_mean=f"{float(lane_len[act].float().mean()):.1f}",
          **measure, ms=f"{ms:.4f}",
          device_ms=device_ms_field(per, "gather_flux_kernel"),
          before_redesign_ms=BEFORE_REDESIGN_MS["gather_flux_events"],
          cold_l2_ms=f"{cold_ms:.4f}", chunk_gather_ms=f"{chunk_ms:.4f}",
          max_abs_diff_vs_chunk_gather=f"{float(diff.max()):.6e}",
          max_rel_diff_vs_chunk_gather=f"{rel:.6e}",
          within_rtol_1e_4_atol_1e_6=close,
          bound_ms=f"{g_bound['bound_ms']:.4f}")
    require(close, "the raster gather differs from the chunk gather beyond "
            "rtol 1e-4, atol 1e-6")
    return entry("gather_flux", "gather_flux.cu",
                 "pallas/gather_kernel.py:510", err, ms, plain_ms, **g_bound,
                 shape=f"cornell iteration 1, all {nblk} blocks (ms, "
                 f"bound_ms); {len(blocks)} blocks (plain_ms, "
                 "ms_checked_blocks)", ms_checked_blocks=ms_sub,
                 device_ms_cold_l2=cold_ms, path=None)


def ppm_phases(torch, np, dev, smi):
    """Phases 6-8: the photon mapper's kernels, the raster-grid gather, the
    cornell render and its CLI. Returns (kernel JSON entries without
    launches, launch counts of the render, the raster gather's entry, the
    render's photon map lengths)."""
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
    n_sph = int(scene.valid.sum())
    for label, org, d, alive in (("photon_b0", p_org, p_d, p_alive),
                                 ("eye_b0", e_org, e_d, e_alive)):
        args = (org.contiguous(), d.contiguous(), alive)
        n, n_alive = org.shape[0], int(alive.sum())
        # rays in (24 B + the alive byte), outputs, the valid primitives
        times[("bound_spheres", label)] = bound(
            n * (25 + 12) + sph.numel() * 4, n_alive * n_sph * OPS["sphere"])
        skips = tri_skips(torch, tk, tri, *args)
        t_bound = times[("bound_tris", label)] = bound(
            n * (25 + 8) + tri.numel() * 4, skips["ops"])
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
            kernel="intersect_tris_kernel",
            host_us=f"{host_us(torch, lambda: tk.intersect_tris(tri, *args)):.1f}",
            **skips, bound_ms=f"{t_bound['bound_ms']:.4f}",
            bound_by=t_bound["bound_by"],
            before_redesign_device_ms=BEFORE_REDESIGN_MS[
                f"intersect_tris_{label}"])
        times[("intersect_tris", label)] = (err_t, kms, pms)

    # the gather at iteration 1: the render's photons, eye hits and radius
    rend = ppm.PPMRenderer(scene, cam, lights, size, size, iterations=iters,
                           photon_count=photons, max_bounces=bounces,
                           verbose=False)
    r1 = rend.radius(1)
    pos, nrm, flux, ok, _ = trace(0)
    photons_t, sbox = gk.build_photon_chunks(pos, nrm, flux, ok)
    pt, nm, _, act = eye.walk(0)
    eye_hits = (pt, nm, act)
    perm = torch.argsort(gk.hit_morton_keys(pt, act), stable=True)
    pt, nm, act = pt[perm].contiguous(), nm[perm].contiguous(), act[perm]
    lists, counts = gk.block_chunk_lists(pt, act, sbox, r1)
    nblk = counts.shape[0]
    longest = torch.argsort(counts, descending=True, stable=True)[
        :GATHER_LONGEST].tolist()
    spaced = [b for b in np.linspace(0, nblk - 1, GATHER_SPACED + 8)
              .round().astype(int).tolist() if b not in longest]
    blocks = sorted(longest + spaced[:GATHER_SPACED])
    rows = torch.cat([torch.arange(b * 1024, (b + 1) * 1024, device=dev)
                      for b in blocks])
    sub = (pt[rows].contiguous(), nm[rows].contiguous(), act[rows])
    walk = gather_walk(torch, gk, pt, act, lists, counts, sbox, r1)
    blk, _, chunk, _, walked = walk

    # the bound's work, for the checked blocks and for all: the walked
    # pairs (each listed sub-chunk's photons x the active hits of the warps
    # whose box meets it; every other pair adds an exact +0.0); bytes: the
    # hits in and sums out, the list words, the walked sub-chunks' photons
    def gather_bound(bl):
        sel = torch.isin(blk, torch.as_tensor(list(bl), device=dev))
        keys = (chunk[sel, None] * gk.N_SUBS
                + torch.arange(gk.N_SUBS, device=dev))[walked[sel] > 0]
        return bound(len(bl) * 1024 * (25 + 12) + int(sel.sum()) * 4
                     + int(torch.unique(keys).numel()) * gk.SUB * 9 * 4,
                     int(walked[sel].sum()) * gk.SUB * OPS["gather"])

    g_bound = gather_bound(blocks)
    g_bound_all = gather_bound(range(nblk))
    work = gather_work(torch, gk, act, counts, walk)
    full = gk.gather_flux_chunks(pt, nm, act, sbox, photons_t, r1)
    torch.cuda.synchronize()
    err_g, g_ms_sub, g_plain_ms, (want_rows,) = compare(
        torch, "gather_flux_chunks",
        lambda: gk.gather_flux_chunks(*sub, sbox, photons_t, r1),
        lambda: gk.gather_flux_chunks_plain(*sub, sbox, photons_t, r1),
        f"{len(blocks)}_of_{nblk}_blocks", kernel="gather_chunks_",
        plain_reps=3, plain_batch=1, plain_prof=1,
        list_lengths=json.dumps(counts[blocks].tolist()),
        before_split_device_ms=BEFORE_SPLIT_MS["gather_checked_blocks"])
    require(torch.equal(full[rows], want_rows),
            "the full-size gather differs from the plain version on the "
            "checked blocks")
    g_ms = time_ms(torch, lambda: gk.gather_flux_chunks(
        pt, nm, act, sbox, photons_t, r1))
    _, per, _, _ = device_times(torch, lambda: gk.gather_flux_chunks(
        pt, nm, act, sbox, photons_t, r1), reps=5)
    g_dev_ms = kernel_ms(per, "gather_chunks_")
    phase("gather_flux_chunks_full", hits=pt.shape[0], blocks=nblk,
          photon_columns=photons_t.shape[1], radius=f"{r1:.6f}",
          list_max=int(counts.max()),
          list_mean=f"{float(counts.float().mean()):.2f}", seg=gk.SEG,
          **work, ms=f"{g_ms:.4f}", device_ms=f"{g_dev_ms:.4f}",
          items_kernel_ms=f"{kernel_ms(per, 'gather_chunks_items'):.4f}",
          combine_kernel_ms=f"{kernel_ms(per, 'gather_chunks_combine'):.4f}",
          before_split_device_ms=BEFORE_SPLIT_MS["gather_all_blocks"],
          wrapper_device_ms=f"{sum(per.values()):.4f}",
          bound_ms=f"{g_bound_all['bound_ms']:.4f}",
          bound_ms_checked_blocks=f"{g_bound['bound_ms']:.4f}")
    raster = raster_gather_phase(torch, np, (pos, nrm, flux, ok), eye_hits,
                                 r1, (photons_t, sbox))

    # --- 7. the cornell render -------------------------------------------
    counters = {"intersect_spheres": sk.intersect_spheres,
                "intersect_tris": tk.intersect_tris,
                "gather_flux_chunks": gk.gather_flux_chunks,
                **no_path_kernels()}
    for fn in counters.values():
        fn.launches = 0
    marks = []

    def tick(i, img_sum):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    waits = []
    block_items = timed_host_read(torch, gk, waits)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_sum = rend.render(checkpoint_cb=tick)
    launches = {k: fn.launches for k, fn in counters.items()}
    gk.block_items = block_items
    read_no_path("cornell", launches)
    from pathtracer_tpu_torch.utils import tracing
    walk = {k: tracing.images()[-1].counts[f"ppm.{k}"]
            for k in ("walk_live", "walk_lanes")}
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
          host_read_wait_ms=json.dumps([round(w, 4) for w in waits]),
          launches=json.dumps(launches), **walk, walk_live_pct=(
              f"{100.0 * walk['walk_live'] / walk['walk_lanes']:.3f}"),
          gpu=json.dumps(smi))
    require(all(n > 0 for n in launches.values()),
            f"a kernel did not run on the cornell path: {launches}")
    require(len_err <= PPM_LENGTH_SLACK,
            f"photon map lengths {lengths} vs {ref_len}")
    require(rmse < PPM_RMSE_BUDGET, f"cornell RMSE {rmse} >= "
            f"{PPM_RMSE_BUDGET}")

    # device time of one warm iteration of a second render of the same
    # renderer; the idle share of that iteration's own wall, and of the
    # unprofiled median beside it
    prof, prof_wall_ms, _ = profile_second_iteration(torch, rend)
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
          intersect_tris_before_redesign_ms=BEFORE_REDESIGN_MS[
              "intersect_tris_cornell_iteration"],
          gather_ms=f"{kernel_ms(per, 'gather_chunks_'):.3f}",
          gather_before_split_ms=BEFORE_SPLIT_MS["gather_cornell_iteration"],
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

    kernels = [
        entry("intersect_spheres", "intersect_spheres.cu",
              "pallas/sphere_kernel.py:302", *times[("intersect_spheres", "eye_b0")],
              **times[("bound_spheres", "eye_b0")],
              shape="cornell eye bounce-0 rays, 360448 x 3 valid spheres"),
        entry("intersect_tris", "intersect_tris.cu",
              "pallas/tri_kernel.py:140",
              *times[("intersect_tris", "eye_b0")],
              **times[("bound_tris", "eye_b0")],
              shape="cornell eye bounce-0 rays, 360448 x 18 valid triangles"),
        entry("gather_flux_chunks", "gather_chunks.cu",
              "pallas/gather_kernel.py:468", err_g, g_ms_sub, g_plain_ms,
              **g_bound, shape=f"{len(blocks)} of {nblk} blocks at "
              "iteration 1 (ms, plain_ms, bound_ms); all blocks (the "
              "*_all_blocks keys)", ms_all_blocks=g_ms,
              device_ms_all_blocks=g_dev_ms,
              bound_ms_all_blocks=g_bound_all["bound_ms"],
              bound_by_all_blocks=g_bound_all["bound_by"],
              items_all_blocks=work["items"], seg=gk.SEG),
    ]
    return kernels, launches, raster, lengths


def tile_real_counts(np, ttk, tt):
    """Each tile's real triangles in a TileTriTable: its columns before the
    zero padding."""
    real = np.flatnonzero((tt.table[3:9] != 0).any(axis=0))
    return np.array([np.count_nonzero(
        (real >= tt.tile_chunk_start[i] * ttk.CHUNK)
        & (real < tt.tile_chunk_start[i + 1] * ttk.CHUNK))
        for i in range(len(tt.tile_chunk_start) - 1)])


def tile_kernel_check(torch, np, name, tt, tile, d, size):
    """intersect_tile_tris on a table (TileTriTable tt, its tensors `tile`)
    and the raster directions d of a band of whole tiles at width `size`:
    the plain version on 32 tiles (the 16 with the longest lists and 16
    spaced) against the kernel on the same tiles (the other tiles given the
    zero chunk) and on all tiles, with times, work items (one per
    256-triangle chunk) and the bound. Prints the `name` and `name`_full
    lines; returns their numbers."""
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk

    dev = d.device
    rows = d.shape[0] // size
    n_real = tile_real_counts(np, ttk, tt)
    n_tiles = len(n_real)
    longest = np.argsort(-n_real, kind="stable")[:TILE_LONGEST].tolist()
    spaced = [t for t in np.linspace(0, n_tiles - 1, TILE_SPACED + 8)
              .round().astype(int).tolist() if t not in longest]
    tiles = sorted(longest + spaced[:TILE_SPACED])
    # the checked tiles keep their lists, the others get the zero chunk:
    # the kernel then computes the same tiles as the plain version
    keep = np.isin(np.arange(n_tiles), tiles)
    start = tt.tile_chunk_start
    sub_src = np.concatenate([
        tt.tile_chunk_src[start[t]:start[t + 1]] if keep[t]
        else [tt.zero_chunk] for t in range(n_tiles)]).astype(np.int32)
    sub_start = np.concatenate([[0], np.cumsum(
        np.where(keep, np.diff(start), 1))]).astype(np.int32)
    sub = (tile[0], torch.from_numpy(sub_start).to(dev),
           torch.from_numpy(sub_src).to(dev))
    err, ms_checked, plain_ms, want = compare(
        torch, name, lambda: ttk.intersect_tile_tris(*sub, d, size),
        lambda: ttk.intersect_tile_tris_plain(*sub, d, size, tiles=tiles),
        f"{len(tiles)}_of_{n_tiles}_tiles", kernel="intersect_tile_tris",
        plain_reps=2, plain_batch=1, plain_prof=1,
        list_lengths=json.dumps(n_real[tiles].tolist()))
    full = ttk.intersect_tile_tris(*tile, d, size)
    y, x = np.divmod(np.arange(rows * size), size)
    mine = torch.from_numpy(keep[(y // ttk.TILE) * tt.tx_n
                                 + x // ttk.TILE]).to(dev)
    require(all(torch.equal(f[mine], w[mine]) for f, w in zip(full, want)),
            f"{name}: the full-size tile kernel differs from the plain "
            "version on the checked tiles")
    t_ms = time_ms(torch, lambda: ttk.intersect_tile_tris(*tile, d, size))
    _, per, _, _ = device_times(
        torch, lambda: ttk.intersect_tile_tris(*tile, d, size), reps=5)
    # pairs: each tile's real triangles x its pixels inside the image
    tw = np.minimum(ttk.TILE, size - (np.arange(n_tiles) % tt.tx_n)
                    * ttk.TILE)
    th = np.minimum(ttk.TILE, tt.height - (np.arange(n_tiles) // tt.tx_n)
                    * ttk.TILE)
    pairs = int((n_real * tw * np.maximum(th, 0)).sum())
    t_bound = bound(d.numel() * 4 + rows * size * 16
                    + int(n_real.sum()) * 10 * 4 + tile[1].numel() * 4
                    + tile[2].numel() * 4, pairs * OPS["tile_tri"])
    items = len(tt.tile_chunk_src)
    phase(f"{name}_full", rays=rows * size, tiles=n_tiles, pairs=pairs,
          items=items, ms=f"{t_ms:.4f}",
          device_ms=device_ms_field(per, "intersect_tile_tris"),
          items_kernel_ms=device_ms_field(per, "intersect_tile_tris_items"),
          combine_kernel_ms=device_ms_field(per,
                                            "intersect_tile_tris_combine"),
          before_split_device_ms=BEFORE_SPLIT_MS["tile"],
          wrapper_device_ms=f"{sum(per.values()):.4f}",
          bound_ms=f"{t_bound['bound_ms']:.4f}",
          hits=int((full[0] < ttk.BIG).sum()))
    return dict(err=err, ms_checked=ms_checked, plain_ms=plain_ms, ms=t_ms,
                device_ms=(kernel_ms(per, "intersect_tile_tris") if any(
                    "intersect_tile_tris" in k for k in per) else None),
                bound=t_bound, items=items, n_real=n_real, tiles=tiles,
                full=full)


def recorded_walks(mesh, run):
    """The inputs (org, d, t_max0, active) of each mesh.intersect call (the
    BVH8 walk) that run() makes, cloned, in call order."""
    walk_in, walk = [], mesh.intersect

    def record(org, d, t_max0, active):
        walk_in.append(tuple(x.clone() for x in (org, d, t_max0, active)))
        return walk(org, d, t_max0, active)

    mesh.intersect = record
    try:
        run()
    finally:
        del mesh.intersect
    return walk_in


def walk_work(torch, bw, args, walk="bvh8"):
    """The plain BVH8 (or BVH4) walk on args with its step counts: (its
    outputs, the phase fields: active lanes, steps per active lane (mean,
    max), node and pair steps, table rows read and bound_ms; the bound).
    The bound's bytes are the table rows read, the rays (29 B) and results
    (17 B); its operations each node row's and each pair row's tests
    (OPS)."""
    plain, node_ops, lanes = (
        (bw.bvh8_walk_plain, OPS["node"], bw.LANES_PER_RAY) if walk == "bvh8"
        else (bw.bvh4_walk_plain, OPS["node4"], bw.BVH4_LANES_PER_RAY))
    *want, steps, visited = plain(*args, count_steps=True)
    active = args[4]
    lane_steps = steps.sum(dim=1)[active].float()
    w_bound = bound(int(visited.sum()) * 128 + active.numel() * (29 + 17),
                    int(steps[:, 0].sum()) * node_ops
                    + int(steps[:, 1].sum()) * 2 * OPS["tri"])
    fields = dict(
        active=int(active.sum()), lanes_per_ray=lanes,
        steps_mean=f"{float(lane_steps.mean()):.2f}",
        steps_max=int(lane_steps.max()),
        node_steps=int(steps[:, 0].sum()),
        pair_steps=int(steps[:, 1].sum()),
        rows_read=int(visited.sum()),
        bound_ms=f"{w_bound['bound_ms']:.4f}")
    return want, fields, w_bound


def mesh_phases(torch, np, dev, smi):
    """Phases 9-13: the ganesha mesh, its two kernels against their plain
    versions, the ganesha render and its CLIs, the path-traced ganesha.
    Returns (kernel JSON entries without launches, launch counts of the
    ganesha render's five kernels, of the path-traced render's six, and
    phase 13's numbers for the JSON entries)."""
    rend, kernels = mesh_kernel_phases(torch, np, dev)
    launches = ganesha_phases(torch, np, smi, rend)
    return (kernels, launches, *ganesha_pt_phases(torch, np, smi, rend))


def mesh_kernel_phases(torch, np, dev):
    """Phases 9-10. Returns (the ganesha PPMRenderer, its tile table built,
    and the JSON entries of the two mesh kernels)."""
    from pathtracer_tpu_torch import native, ppm
    from pathtracer_tpu_torch.models import ganesha
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk
    from pathtracer_tpu_torch.ops.cuda import tri_kernel as tk
    from pathtracer_tpu_torch.scene import TRI_A, TRI_E1, TRI_E2

    size, iters, photons, bounces = (PPM_SIZE, PPM_ITERS, PPM_PHOTONS,
                                     PPM_BOUNCES)
    # --- 9. the mesh: g++ build of native/, PLY, BVH, walk and tile tables
    t0 = time.perf_counter()
    native.load()
    gpp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene, cam, lights, mesh = ganesha.build(GANESHA_PLY, 1.0, dev)
    build_s = time.perf_counter() - t0
    rend = ppm.PPMRenderer(scene, cam, lights, size, size, iterations=iters,
                           photon_count=photons, max_bounces=bounces,
                           verbose=False, mesh=mesh)
    t0 = time.perf_counter()
    tile = rend.tile_tensors(1)
    tile_s = time.perf_counter() - t0
    tt = rend.tile_table
    n_real = tile_real_counts(np, ttk, tt)
    phase("mesh", triangles=mesh.n_tris, depth=mesh.depth,
          walk_table_rows=mesh.table_np.shape[0], node_end=mesh.node_end,
          stride=mesh.stride, gpp_build_s=f"{gpp_s:.3f}",
          mesh_build_s=f"{build_s:.3f}", tile_table_s=f"{tile_s:.3f}",
          tile_columns=tt.table.shape[1], tiles=len(n_real),
          list_mean=f"{n_real.mean():.2f}", list_max=int(n_real.max()),
          chunks=int(tt.tile_chunk_start[-1]))
    require(mesh.n_tris == GANESHA_TRIS, f"{mesh.n_tris} triangles")

    # --- 10. the two kernels against their plain versions ------------------
    # the walk's inputs as iteration 1's photon pass makes them (org, d, the
    # pool winner's t as t_max0, alive), bounces 0 and 1
    trace, _, _ = ppm.make_photon_pass(scene, lights, photons, bounces, mesh)
    walk_in = recorded_walks(mesh, lambda: trace(0))
    require(len(walk_in) == bounces
            and walk_in[0][0].shape[0] == -(-photons // 1024) * 1024,
            f"walk calls {len(walk_in)}")
    # bounces 0 and 1 timed against the plain version, every bounce held
    # equal to it
    walk_times, walk_bounds, walk_dev = {}, {}, {}
    for b in range(bounces):
        org, d, t_max0, active = walk_in[b]
        args = (mesh.table, org, d, t_max0, active, mesh.node_end,
                mesh.stride)
        want, fields, w_bound = walk_work(torch, bw, args)
        n = org.shape[0]
        if b == 0:
            fields["before_group_device_ms"] = BEFORE_CULL_MS["bvh8_walk"]
        _, per, _, _ = device_times(torch, lambda: bw.bvh8_walk(*args),
                                    reps=5)
        # None where the profiler recorded no launch of the kernel
        walk_dev[b] = (kernel_ms(per, "bvh8_walk_kernel") if any(
            "bvh8_walk_kernel" in k for k in per) else None)
        if b < 2:
            walk_times[b] = compare(
                torch, "bvh8_walk", lambda: bw.bvh8_walk(*args),
                lambda: bw.bvh8_walk_plain(*args),
                f"photon_b{b}:{n}_lanes", kernel="bvh8_walk_kernel",
                plain_reps=2, plain_batch=1, plain_prof=1,
                hits=int(bw.bvh8_walk(*args)[4].sum()), **fields)[:3]
        else:
            got = bw.bvh8_walk(*args)
            torch.cuda.synchronize()
            exact = all(torch.equal(g, w) for g, w in zip(got, want))
            phase("bvh8_walk", shape=f"photon_b{b}:{n}_lanes", equal=exact,
                  device_ms=device_ms_field(per, "bvh8_walk_kernel"),
                  hits=int(got[4].sum()), **fields)
            require(exact, f"bvh8_walk (photon bounce {b}): the kernel "
                    "differs from its plain version")
        walk_bounds[b] = w_bound

    # the floor pool on the photon bounce-0 rays (2 real columns of 128)
    tp = scene.tri_pack
    floor = tk.pack_tris(tp[:, TRI_A], tp[:, TRI_E1], tp[:, TRI_E2],
                         scene.tri_valid)
    fargs = (walk_in[0][0].contiguous(), walk_in[0][1].contiguous(),
             walk_in[0][3])
    compare(torch, "intersect_tris",
            lambda: tk.intersect_tris(floor, *fargs),
            lambda: tk.intersect_tris_plain(floor, *fargs),
            f"ganesha_photon_b0:{fargs[0].shape[0]}x{floor.shape[1]}",
            kernel="intersect_tris_kernel",
            **tri_skips(torch, tk, floor, *fargs))

    # the eye primaries of iteration 1, one band of ceil(H/32)*32 rows
    eye = ppm.make_eye_pass(cam, size, size, bounces, photons, scene, 1,
                            mesh, tile)
    rows = -(-size // ttk.TILE) * ttk.TILE
    d = eye.primary(0)[2][:rows * size].contiguous()
    tile_res = tile_kernel_check(torch, np, "intersect_tile_tris", tt, tile,
                                 d, size)
    n_tiles = len(tile_res["n_real"])

    kernels = [
        entry("bvh8_walk", "bvh8_walk.cu", "bvh.py:892", *walk_times[0],
              **walk_bounds[0],
              shape="ganesha photon bounce-0 rays, 75776 lanes",
              lanes_per_ray=bw.LANES_PER_RAY, device_ms=walk_dev[0],
              device_ms_by_bounce=[walk_dev[b] and round(walk_dev[b], 4)
                                   for b in range(bounces)],
              ms_bounce1=walk_times[1][1], plain_ms_bounce1=walk_times[1][2],
              bound_ms_bounce1=walk_bounds[1]["bound_ms"]),
        entry("intersect_tile_tris", "intersect_tile_tris.cu",
              "pallas/tile_tri_kernel.py:142", tile_res["err"],
              tile_res["ms"], tile_res["plain_ms"], **tile_res["bound"],
              shape=f"ganesha eye primaries, all {n_tiles} tiles "
              f"(ms, bound_ms); {len(tile_res['tiles'])} tiles (plain_ms, "
              "ms_checked_tiles)", ms_checked_tiles=tile_res["ms_checked"],
              device_ms=tile_res["device_ms"], items=tile_res["items"]),
    ]
    return rend, kernels


def ganesha_phases(torch, np, smi, rend):
    """Phases 11-12: the ganesha render through PPMRenderer.render and the
    CLIs. Returns the launch counts of the render's five kernels."""
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw
    from pathtracer_tpu_torch.ops.cuda import gather_kernel as gk
    from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk
    from pathtracer_tpu_torch.ops.cuda import tri_kernel as tk

    size, iters, photons, bounces = (PPM_SIZE, PPM_ITERS, PPM_PHOTONS,
                                     PPM_BOUNCES)
    # --- 11. the ganesha eye pass and render ---------------------------------
    eye_witness(torch, np, rend)
    counters = {"intersect_spheres": sk.intersect_spheres,
                "intersect_tris": tk.intersect_tris,
                "gather_flux_chunks": gk.gather_flux_chunks,
                "bvh8_walk": bw.bvh8_walk,
                "intersect_tile_tris": ttk.intersect_tile_tris,
                **no_path_kernels()}
    for fn in counters.values():
        fn.launches = 0
    marks = []

    def tick(i, img_sum):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    waits = []
    block_items = timed_host_read(torch, gk, waits)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_sum = rend.render(checkpoint_cb=tick)
    launches = {k: fn.launches for k, fn in counters.items()}
    gk.block_items = block_items
    read_no_path("ganesha", launches)
    iter_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    lengths = [int(n) for n in rend.photon_map_lengths]
    ref = np.load(GANESHA_REF)
    img = img_sum.cpu().numpy() / iters
    require(img.shape == ref["img"].shape == (size, size, 3),
            f"image shape {img.shape}")
    require(bool(np.isfinite(img).all()), "image has non-finite pixels")
    ref_img = ref["img"].astype(np.float64)
    rmse = float(np.sqrt(np.mean((img - ref_img) ** 2)))
    ref_rms = float(np.sqrt(np.mean(ref_img ** 2)))
    budget = GANESHA_RMSE_SHARE * ref_rms
    binned = [x.reshape(size // 8, 8, size // 8, 8, 3).mean(axis=(1, 3))
              for x in (img, ref_img)]
    b_rms = float(np.sqrt(np.mean(binned[1] ** 2)))
    b_share = float(np.sqrt(np.mean((binned[0] - binned[1]) ** 2))) / b_rms
    ref_len = [int(n) for n in ref["photon_map_lengths"]]
    len_err = max(abs(a - b) / b for a, b in zip(lengths, ref_len))
    MESH_WALLS["ganesha"] = dict(
        first_iter_s=iter_s[0], median_s_per_iter=statistics.median(
            iter_s[1:]))
    phase("ganesha_render",
          config=f"{size}x{size},iters={iters},photons={photons},"
                 f"b={bounces}",
          first_iter_s=f"{iter_s[0]:.4f}",
          median_s_per_iter=f"{statistics.median(iter_s[1:]):.4f}",
          iter_s=json.dumps([round(t, 4) for t in iter_s]),
          photon_map_lengths=json.dumps(lengths),
          reference_lengths=json.dumps(ref_len),
          max_length_rel_err=f"{len_err:.3e}", rmse=f"{rmse:.6e}",
          rmse_budget=f"{budget:.6e}",
          rmse_share_of_rms=f"{rmse / ref_rms:.4e}",
          binned8_rmse_share=f"{b_share:.4e}",
          max_abs_diff=f"{float(np.abs(img - ref_img).max()):.6e}",
          pixels_off_by_1e_2=int((np.abs(img - ref_img).max(axis=-1)
                                  > 1e-2).sum()),
          black_pixel_share=f"{float((ref_img.max(axis=-1) == 0).mean()):.4f}",
          host_read_wait_ms=json.dumps([round(w, 4) for w in waits]),
          launches=json.dumps(launches), gpu=json.dumps(smi))
    require(all(n > 0 for n in launches.values()),
            f"a kernel did not run on the ganesha path: {launches}")
    require(len_err <= PPM_LENGTH_SLACK,
            f"photon map lengths {lengths} vs {ref_len}")
    require(rmse <= budget, f"ganesha RMSE {rmse} > {budget}")
    require(b_share <= GANESHA_BINNED_SHARE,
            f"ganesha 8x8-binned RMSE share {b_share} > "
            f"{GANESHA_BINNED_SHARE}")

    # one warm iteration profiled, as the cornell phase does; then the
    # same two iterations with the walk for the eye rays (tile_primary
    # False): the same image but where two triangles tie exactly in t
    prof, prof_wall_ms, tile_sum = profile_second_iteration(torch, rend)
    walk_sum = dataclasses.replace(rend, tile_primary=False).render()
    ab_diff = float((tile_sum - walk_sum).abs().max())
    median_ms = statistics.median(iter_s[1:]) * 1e3
    busy_ms, per, n_ops = device_per_kernel(prof, 1)
    top = sorted(per.items(), key=lambda kv: -kv[1])
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "ganesha_profile.txt"), "w") as f:
        f.write(f"{smi}\nwall_ms(profiled iteration)={prof_wall_ms:.3f} "
                f"wall_ms(unprofiled median)={median_ms:.3f} "
                f"device_busy_ms={busy_ms:.3f} device_ops={n_ops:.0f}\n")
        f.writelines(f"{ms:10.4f} ms  {name}\n" for name, ms in top)
    phase("ganesha_profile", wall_ms=f"{prof_wall_ms:.3f}",
          unprofiled_median_ms=f"{median_ms:.3f}",
          device_busy_ms=f"{busy_ms:.3f}",
          device_idle_share=f"{1 - busy_ms / prof_wall_ms:.3f}",
          device_idle_share_of_median=f"{1 - busy_ms / median_ms:.3f}",
          bvh8_walk_ms=f"{kernel_ms(per, 'bvh8_walk_kernel'):.3f}",
          tile_ms=f"{kernel_ms(per, 'intersect_tile_tris'):.3f}",
          gather_ms=f"{kernel_ms(per, 'gather_chunks_'):.3f}",
          gather_before_split_ms=BEFORE_SPLIT_MS["gather_ganesha_iteration"],
          tile_before_split_ms=BEFORE_SPLIT_MS["tile"],
          intersect_tris_ms=f"{kernel_ms(per, 'intersect_tris_kernel'):.3f}",
          intersect_tris_before_redesign_ms=BEFORE_REDESIGN_MS[
              "intersect_tris_ganesha_iteration"],
          intersect_spheres_ms=f"{kernel_ms(per, 'intersect_spheres_kernel'):.3f}",
          device_ops=f"{n_ops:.0f}", kernels_seen=len(per),
          tile_vs_walk_eye_max_abs=f"{ab_diff:.6e}")

    # --- 12. the ganesha and ply-describe CLIs ------------------------------
    png = os.path.join(OUT, f"ganesha_{size}x{size}.png")
    if os.path.exists(png):
        os.remove(png)
    ply_arg = os.path.relpath(GANESHA_PLY, ROOT)
    runs = {
        "render": ["ganesha", "-ganesha-ply", ply_arg, "-width", str(size),
                   "-height", str(size), "-iterations", "2",
                   "-photon-count", str(photons), "-max-bounces",
                   str(bounces), "-no-progress", "-o", png],
        "stop_after_bvh": ["ganesha", "-ganesha-ply", ply_arg,
                           "-stop-after-bvh"],
        "ply_describe": ["ply-describe",
                         os.path.join("scenes", "test_ganesha.ply")],
    }
    said = {}
    for label, argv in runs.items():
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "pathtracer_tpu_torch",
                              *argv], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        require(run.returncode == 0,
                f"{label} CLI failed:\n{run.stdout}\n{run.stderr}")
        said[label] = (time.perf_counter() - t0, run.stdout.splitlines())
    png_wh = png_size(png)
    stats = said["stop_after_bvh"][1]
    phase("ganesha_cli", seconds=f"{said['render'][0]:.3f}",
          png=os.path.relpath(png, ROOT), size=f"{png_wh[0]}x{png_wh[1]}",
          said=json.dumps(said["render"][1][-1]),
          stop_after_bvh_s=f"{said['stop_after_bvh'][0]:.3f}",
          stats=json.dumps([ln for ln in stats if ln.startswith(
              ("#triangles", "tree depth", "build time", "bvh bytes"))]),
          ply_describe=json.dumps(said["ply_describe"][1][:2]))
    require(png_wh == (size, size), f"PNG is {png_wh}")
    require(f"#triangles = {GANESHA_TRIS}" in stats
            and stats[-1] == "Stop after bvh build",
            f"-stop-after-bvh said {stats}")
    require(said["ply_describe"][1][0] == "format = binary_little_endian",
            f"ply-describe said {said['ply_describe'][1][:1]}")

    return launches


def ganesha_pt_phases(torch, np, smi, ppm_rend):
    """Phase 13: the path-traced ganesha (models.ganesha.build_pt's scene)
    on phase 9's floor, camera and MeshBVH under the shirley sky. Returns
    (the render's launch counts of its six kernels, the numbers the
    kernels' JSON entries take from this phase)."""
    from pathtracer_tpu_torch.integrator import MeshRenderer, make_render_fn
    from pathtracer_tpu_torch.io.png import write_png
    from pathtracer_tpu_torch.models import shirley
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw
    from pathtracer_tpu_torch.ops.cuda import mesh_bounce_kernel as mbk
    from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk
    from pathtracer_tpu_torch.ops.cuda import tri_kernel as tk
    from pathtracer_tpu_torch.scene import TRI_A, TRI_E1, TRI_E2

    size, spp, bounces = PT_SIZE, PT_SPP, PT_BOUNCES
    scene, cam, mesh = ppm_rend.scene, ppm_rend.camera, ppm_rend.mesh
    bg, dev = shirley.BACKGROUND, scene.center.device
    # --- 13. the flip_y tile table, built by the renderer ------------------
    t0 = time.perf_counter()
    r = MeshRenderer(scene, cam, bg, size, size, spp, bounces, dev, mesh)
    table_s = time.perf_counter() - t0
    tt = r.tile_table
    n_real = tile_real_counts(np, ttk, tt)
    phase("ganesha_pt_table", flip_y=True, backface_cull=mesh.watertight,
          renderer_s=f"{table_s:.3f}", tile_columns=tt.table.shape[1],
          tiles=len(n_real), list_mean=f"{n_real.mean():.2f}",
          list_max=int(n_real.max()), chunks=int(tt.tile_chunk_start[-1]),
          lanes=r.lane.shape[0])

    # the tile kernel on pass 0's primaries over the flipped table
    _, _, d0, _ = r.primary(0)
    tile = (r.tile, r.tile_start, r.tile_src)
    tile_res = tile_kernel_check(torch, np, "intersect_tile_tris_pt", tt,
                                 tile, d0[:r.rows * size].contiguous(), size)

    # pass 0's walk inputs at bounces 1-7 (bounce 0 takes the tile kernel):
    # rays leaving the floor and the mesh in every direction
    walk_in = recorded_walks(mesh, lambda: r.trace_pass(0))
    require(len(walk_in) == bounces - 1, f"walk calls {len(walk_in)}")
    live = [int(r.alive0.sum())] + [int(w[3].sum()) for w in walk_in]
    pt = {}
    for b in PT_WALK_BOUNCES:
        args = (mesh.table, *walk_in[b - 1], mesh.node_end, mesh.stride)
        t0 = time.perf_counter()
        want, fields, w_bound = walk_work(torch, bw, args)
        plain_s = time.perf_counter() - t0
        got = bw.bvh8_walk(*args)
        torch.cuda.synchronize()
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        kms = time_ms(torch, lambda: bw.bvh8_walk(*args))
        _, per, _, _ = device_times(torch, lambda: bw.bvh8_walk(*args),
                                    reps=5)
        dev_ms = (kernel_ms(per, "bvh8_walk_kernel") if any(
            "bvh8_walk_kernel" in k for k in per) else None)
        phase("bvh8_walk_pt", shape=f"pt_b{b}:{args[1].shape[0]}_lanes",
              equal=exact, ms=f"{kms:.4f}",
              device_ms=device_ms_field(per, "bvh8_walk_kernel"),
              plain_count_steps_s=f"{plain_s:.3f}",
              bound_by=w_bound["bound_by"], hits=int(got[4].sum()),
              **fields)
        require(exact, f"bvh8_walk (path-traced bounce {b}): the kernel "
                "differs from its plain version")
        pt[f"walk_b{b}"] = dict(ms=kms, device_ms=dev_ms,
                                bound_ms=w_bound["bound_ms"],
                                bound_by=w_bound["bound_by"],
                                steps_max=fields["steps_max"])

    # the pool kernels on the bounce-1 rays
    org, d, _, alive = walk_in[0]
    pargs = (org.contiguous(), d.contiguous(), alive)
    sph = sk.pack_spheres(scene.center, scene.radius, scene.valid)
    tp = scene.tri_pack
    floor = tk.pack_tris(tp[:, TRI_A], tp[:, TRI_E1], tp[:, TRI_E2],
                         scene.tri_valid)
    # bounds as phase 6 counts them: the rays in, the outputs, the table
    n, n_alive = org.shape[0], int(alive.sum())
    skips = tri_skips(torch, tk, floor, *pargs)
    s_bound = bound(n * (25 + 12) + sph.numel() * 4,
                    n_alive * int(scene.valid.sum()) * OPS["sphere"])
    t_bound = bound(n * (25 + 8) + floor.numel() * 4, skips["ops"])
    pt["spheres_b1"] = (compare(
        torch, "intersect_spheres", lambda: sk.intersect_spheres(sph, *pargs),
        lambda: sk.intersect_spheres_plain(sph, *pargs),
        f"pt_b1:{n}x{sph.shape[1]}", kernel="intersect_spheres_kernel",
        plain_reps=2, plain_batch=1, plain_prof=1,
        bound_ms=f"{s_bound['bound_ms']:.4f}",
        bound_by=s_bound["bound_by"])[1], s_bound["bound_ms"])
    pt["tris_b1"] = (compare(
        torch, "intersect_tris", lambda: tk.intersect_tris(floor, *pargs),
        lambda: tk.intersect_tris_plain(floor, *pargs),
        f"pt_b1:{n}x{floor.shape[1]}", kernel="intersect_tris_kernel",
        plain_reps=2, plain_batch=1, plain_prof=1, **skips,
        bound_ms=f"{t_bound['bound_ms']:.4f}",
        bound_by=t_bound["bound_by"])[1], t_bound["bound_ms"])

    # the bounce kernels against their plain version on pass 0's bounces
    for c in mbk.plain_bounces(r, max(PT_BOUNCE_CHECKS) + 1):
        if c["b"] in PT_BOUNCE_CHECKS:
            pt[f"bounce_b{c['b']}"] = mesh_bounce_check(torch, r, c)

    # --- the render through make_render_fn(..., mesh=mesh) ----------------
    render = make_render_fn(cam, bg, size, size, spp, bounces, dev,
                            mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render(scene)  # the first render builds its tile table
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counters = {"intersect_spheres": sk.intersect_spheres,
                "intersect_tris": tk.intersect_tris,
                "bvh8_walk": bw.bvh8_walk,
                "intersect_tile_tris": ttk.intersect_tile_tris,
                "winner_t": mbk.winner_t, "mesh_bounce": mbk.mesh_bounce,
                **no_path_kernels()}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    img_t, segments = render(scene)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = {k: fn.launches for k, fn in counters.items()}
    read_no_path("ganesha_pt", launches)
    for _ in range(PT_WARM_RENDERS - 1):
        t0 = time.perf_counter()
        render(scene)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    img = img_t.cpu().numpy().astype(np.float64)
    ref = np.load(GANESHA_PT_REF)
    ref_img = ref["img"].astype(np.float64)
    require(img.shape == ref_img.shape == (size, size, 3),
            f"image shape {img.shape}")
    require(bool(np.isfinite(img).all()), "image has non-finite pixels")
    ref_segs = int(ref["segments"])
    rmse = float(np.sqrt(np.mean((img - ref_img) ** 2)))
    ref_rms = float(np.sqrt(np.mean(ref_img ** 2)))
    binned = [x.reshape(size // 8, 8, size // 8, 8, 3).mean(axis=(1, 3))
              for x in (img, ref_img)]
    b_share = (float(np.sqrt(np.mean((binned[0] - binned[1]) ** 2)))
               / float(np.sqrt(np.mean(binned[1] ** 2))))
    want_launches = {"intersect_spheres": spp * bounces,
                     "intersect_tris": spp * bounces,
                     "bvh8_walk": spp * (bounces - 1),
                     "intersect_tile_tris": spp,
                     "winner_t": spp * bounces, "mesh_bounce": spp * bounces}
    wall_s = statistics.median(walls)
    MESH_WALLS["ganesha_pt"] = dict(first_render_s=first_s, wall_s=wall_s)
    os.makedirs(OUT, exist_ok=True)
    png = os.path.join(OUT, f"ganesha_pt_{size}x{size}_spp{spp}.png")
    write_png(png, img)
    phase("ganesha_pt_render",
          config=f"{size}x{size},spp={spp},b={bounces}", segments=segments,
          reference_segments=ref_segs, tpu_segments=GANESHA_PT_TPU_SEGMENTS,
          segments_rel_err=f"{abs(segments - ref_segs) / ref_segs:.3e}",
          live_lanes_pass0=json.dumps(live),
          first_render_s=f"{first_s:.4f}", wall_s=f"{wall_s:.4f}",
          walls_s=json.dumps([round(w, 4) for w in walls]),
          mrays_per_s=f"{segments / wall_s / 1e6:.3f}", rmse=f"{rmse:.6e}",
          rmse_share_of_rms=f"{rmse / ref_rms:.4e}",
          rmse_budget_share=GANESHA_PT_RMSE_SHARE,
          binned8_rmse_share=f"{b_share:.4e}",
          binned8_budget_share=GANESHA_PT_BINNED_SHARE,
          max_abs_diff=f"{float(np.abs(img - ref_img).max()):.6e}",
          pixels_off_by_1e_2=int((np.abs(img - ref_img).max(axis=-1)
                                  > 1e-2).sum()),
          png=os.path.relpath(png, ROOT), launches=json.dumps(launches),
          gpu=json.dumps(smi))
    require(launches == want_launches,
            f"path-traced ganesha launches {launches}, want {want_launches}")
    require(abs(segments - ref_segs) <= PT_SEGMENT_SLACK * ref_segs,
            f"segments {segments} vs the reference's {ref_segs}")
    require(rmse <= GANESHA_PT_RMSE_SHARE * ref_rms,
            f"path-traced ganesha RMSE share {rmse / ref_rms} > "
            f"{GANESHA_PT_RMSE_SHARE}")
    require(b_share <= GANESHA_PT_BINNED_SHARE,
            f"path-traced ganesha 8x8-binned RMSE share {b_share} > "
            f"{GANESHA_PT_BINNED_SHARE}")

    # one profiled render: device time by kernel, the idle share of its own
    # wall, and the walk's device ms by bounce (its launches in order are
    # pass-major: bounces 1-7 of each pass)
    with profiler() as prof:
        t0 = time.perf_counter()
        render(scene)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, per, n_ops = device_per_kernel(prof, 1)
    walk_events = launch_ms(prof, "bvh8_walk_kernel")
    by_bounce = None  # where the profiler missed a launch
    if len(walk_events) == spp * (bounces - 1):
        by_bounce = [round(float(np.mean(walk_events[b::bounces - 1])), 4)
                     for b in range(bounces - 1)]
    top = sorted(per.items(), key=lambda kv: -kv[1])
    with open(os.path.join(OUT, "ganesha_pt_profile.txt"), "w") as f:
        f.write(f"{smi}\nwall_ms(profiled render)={prof_wall_ms:.3f} "
                f"wall_ms(unprofiled median)={wall_s * 1e3:.3f} "
                f"device_busy_ms={busy_ms:.3f} device_ops={n_ops:.0f}\n"
                f"bvh8_walk device ms by bounce 1-{bounces - 1} (mean of "
                f"{spp} passes)={json.dumps(by_bounce)}\n")
        f.writelines(f"{ms:10.4f} ms  {name}\n" for name, ms in top)
    phase("ganesha_pt_profile", wall_ms=f"{prof_wall_ms:.3f}",
          unprofiled_median_ms=f"{wall_s * 1e3:.3f}",
          device_busy_ms=f"{busy_ms:.3f}",
          device_idle_share=f"{1 - busy_ms / prof_wall_ms:.3f}",
          device_idle_share_of_median=f"{1 - busy_ms / (wall_s * 1e3):.3f}",
          bvh8_walk_ms=f"{kernel_ms(per, 'bvh8_walk_kernel'):.3f}",
          bvh8_walk_ms_by_bounce=json.dumps(by_bounce),
          tile_ms=f"{kernel_ms(per, 'intersect_tile_tris'):.3f}",
          intersect_tris_ms=f"{kernel_ms(per, 'intersect_tris_kernel'):.3f}",
          intersect_spheres_ms=f"{kernel_ms(per, 'intersect_spheres_kernel'):.3f}",
          device_ops=f"{n_ops:.0f}", kernels_seen=len(per))
    pt.update(rend=ppm_rend, image=img_t, segments=segments)
    pt.update(tile_ms=tile_res["ms"], tile_device_ms=tile_res["device_ms"],
              tile_bound_ms=tile_res["bound"]["bound_ms"],
              walk_render_ms=kernel_ms(per, "bvh8_walk_kernel"),
              walk_ms_by_bounce=by_bounce)
    return launches, pt


def mesh_bounce_check(torch, r, c) -> dict:
    """Phase 13's check of the bounce kernels on c, one bounce of
    mesh_bounce_kernel.plain_bounces(r, ...) over the path-traced pass 0:
    winner_t and mesh_bounce equal to their plain version on every output
    (bounce_equal), then each kernel's ms (CUDA events around one launch
    behind a device sleep, L2 warm), device ms (profiler, L2 warm: the
    mean of the launches it recorded, as late in a long process it may
    miss some or all of a window's), L2-flushed ms (time_cold_ms) and
    bound, and the plain version's ms (composite_hits after the query,
    scatter_bounce).
    mesh_bounce runs on copies of the lanes, restored before each launch
    outside the timed window. Prints the phase line; returns the numbers of
    the kernels' JSON entries."""
    from pathtracer_tpu_torch import integrator as it
    from pathtracer_tpu_torch.ops.cuda import mesh_bounce_kernel as mbk

    b, pools, hits, offset = c["b"], c["pools"], c["hits"], c["offset"]
    org, d, _, _, alive = c["lanes"]
    equal = mbk.bounce_equal(r, c)
    lanes = [x.clone() for x in c["lanes"]]
    segs = torch.zeros((), dtype=torch.int64, device=org.device)

    def restore():
        for g, x in zip(lanes, c["lanes"]):
            g.copy_(x)

    def bounce():
        mbk.mesh_bounce(r.scene, r.mesh, pools, hits, c["limbs"], offset,
                        r.sky_colors, *lanes, segs)

    def winner():
        mbk.winner_t(r.scene, pools, org, d)

    sky = tuple(x.expand_as(org) for x in r.sky_colors)

    def plain():
        h = it.composite_hits(r.scene, r.mesh, pools, org, d,
                              lambda t_cur: hits)
        return it.scatter_bounce(h, r.sampler, b, offset, sky, *c["lanes"])

    # bytes each must move: winner_t reads every lane's org, d and the
    # pools' at, idx, inv_a, t_t and writes t_cur (44 B); mesh_bounce reads
    # every lane's alive byte, a live lane's state, offset and winners
    # (81 B) and a mesh winner's 36 B row, and writes a miss's radiance and
    # death (13 B), a continuing lane's org, d and attn (36 B) and an ended
    # hit's death (1 B)
    n, live = org.shape[0], int(alive.sum())
    ends, going = c["ends"], int(c["want"][4].sum())
    bounds = {"winner_t": bound(44 * n, 0), "mesh_bounce": bound(
        n + 81 * live + 36 * ends["mesh"] + 13 * ends["sky"] + 36 * going
        + (live - ends["sky"] - going), 0)}
    out = {"plain_ms": time_ms(torch, plain, reps=3, batch=2)}
    for name, fn, prep in (("winner_t", winner, lambda: None),
                           ("mesh_bounce", bounce, restore)):
        with profiler() as prof:
            for _ in range(5):
                prep()
                fn()
            torch.cuda.synchronize()
        seen = launch_ms(prof, f"{name}_kernel")
        out[name] = dict(
            ms=time_cold_ms(torch, fn, prepare=prep, cold=False),
            device_ms=statistics.mean(seen) if seen else None,
            device_launches_seen=len(seen),
            device_ms_cold_l2=time_cold_ms(torch, fn, prepare=prep),
            bound_ms=bounds[name]["bound_ms"])
    phase("mesh_bounce_pt", shape=f"pt_b{b}:{n}_lanes", live=live,
          **ends, continuing=going, equal=json.dumps(equal),
          plain_ms=f"{out['plain_ms']:.4f}",
          **{f"{name}_{k}": "not_seen" if v is None else (
              v if isinstance(v, int) else f"{v:.4f}")
             for name in ("winner_t", "mesh_bounce")
             for k, v in out[name].items()})
    require(all(equal.values()), f"mesh_bounce (path-traced bounce {b}): "
            f"the kernels differ from their plain version: {equal}")
    return out


def eye_witness(torch, np, rend):
    """The eye pass alone at full size: the port's (eye rays through the
    tile kernel, chunk gather, film) over the JAX reference's own
    iteration-1 deposits, against the JAX image of that iteration over
    them; the difference split between pixels whose eye ray meets the mesh
    and floor pixels. The port's image goes to
    chiprun_out/ganesha_eye_witness.npz."""
    from pathtracer_tpu_torch import ppm
    from pathtracer_tpu_torch.ops.cuda import gather_kernel as gk
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk

    size, photons, bounces = PPM_SIZE, PPM_PHOTONS, PPM_BOUNCES
    wit = np.load(GANESHA_WITNESS)
    r1, dev = rend.radius(1), rend.scene.center.device
    require(abs(r1 - float(wit["radius"])) <= 1e-12 * r1,
            f"r(1) {r1} vs the reference's {float(wit['radius'])}")
    tile = rend.tile_tensors(1)
    eye = ppm.make_eye_pass(rend.camera, size, size, bounces, photons,
                            rend.scene, 1, rend.mesh, tile)
    deps = [torch.from_numpy(wit[k]).to(dev) for k in ("pos", "nrm", "flux")]
    ok = torch.ones(deps[0].shape[0], dtype=torch.bool, device=dev)
    photons_t, sbox = gk.build_photon_chunks(*deps, ok)
    one = eye(0, r1, (photons_t, sbox)).flip(0)
    # the gather there: the floor's photons spread over 10,000-unit
    # triangles, so its lists differ from cornell's
    pt, nm, _, act = eye.walk(0)
    perm = torch.argsort(gk.hit_morton_keys(pt, act), stable=True)
    pt, nm, act = pt[perm].contiguous(), nm[perm].contiguous(), act[perm]
    lists, counts = gk.block_chunk_lists(pt, act, sbox, r1)
    work = gather_work(torch, gk, act, counts, gather_walk(
        torch, gk, pt, act, lists, counts, sbox, r1))
    g_ms = time_ms(torch, lambda: gk.gather_flux_chunks(
        pt, nm, act, sbox, photons_t, r1))
    _, per, _, _ = device_times(torch, lambda: gk.gather_flux_chunks(
        pt, nm, act, sbox, photons_t, r1), reps=5)
    phase("gather_flux_chunks_ganesha", hits=pt.shape[0],
          blocks=counts.shape[0], photon_columns=photons_t.shape[1],
          list_max=int(counts.max()),
          list_mean=f"{float(counts.float().mean()):.2f}", **work,
          ms=f"{g_ms:.4f}",
          device_ms=f"{kernel_ms(per, 'gather_chunks_'):.4f}",
          before_split_device_ms_profiled_iteration=BEFORE_SPLIT_MS[
              "gather_ganesha_iteration"])
    one = one.cpu().numpy().astype(np.float64)
    want = wit["img"].astype(np.float64)
    rows = -(-size // ttk.TILE) * ttk.TILE  # the band of whole tiles
    d = eye.primary(0)[2][:rows * size].contiguous()
    t_eye = ttk.intersect_tile_tris(*tile, d, size)[0][:size * size]
    on_mesh = (t_eye < ttk.BIG).cpu().numpy().reshape(size, size)[::-1]
    rms = float(np.sqrt(np.mean(want ** 2)))
    diff = one - want
    w_share = float(np.sqrt(np.mean(diff ** 2))) / rms
    # each part's share of the whole image's squared error: they add to 1
    sq = (diff ** 2).sum(axis=-1)
    off = np.abs(diff).max(axis=-1) > 1e-2
    os.makedirs(OUT, exist_ok=True)
    np.savez_compressed(os.path.join(OUT, "ganesha_eye_witness.npz"),
                        img=one.astype(np.float32), on_mesh=on_mesh)
    phase("ganesha_eye_on_reference_photons", deposits=deps[0].shape[0],
          radius=f"{r1:.6f}", rmse_share_of_rms=f"{w_share:.4e}",
          budget=GANESHA_WITNESS_SHARE,
          max_abs_diff=f"{float(np.abs(diff).max()):.6e}",
          pixels_off_by_1e_2=int(off.sum()),
          mesh_pixels_off_by_1e_2=int((off & on_mesh).sum()),
          pixels_differing=int((diff != 0).any(axis=-1).sum()),
          mesh_pixels=int(on_mesh.sum()),
          mesh_share_of_sq_err=f"{float(sq[on_mesh].sum() / max(sq.sum(), 1e-300)):.4f}",
          mesh_max_rel_diff=f"{float((np.abs(diff) / np.maximum(want, 1e-3))[on_mesh].max()):.4e}",
          floor_max_rel_diff=f"{float((np.abs(diff) / np.maximum(want, 1e-3))[~on_mesh].max()):.4e}",
          black_pixel_share=f"{float((want.max(axis=-1) == 0).mean()):.4f}")
    require(w_share <= GANESHA_WITNESS_SHARE,
            f"the eye pass over the reference's photons: RMSE share "
            f"{w_share} > {GANESHA_WITNESS_SHARE}")


def multi_device_phases(torch, np, dev, smi, shirley_ref, pt_ref,
                        cornell_lengths):
    """Phase 14: multi-device rendering (pathtracer_tpu_torch.parallel).
    shirley_ref: phase 4's (image, segments); pt_ref: phase 13's
    {"rend": phase 9's ganesha PPMRenderer, "image", "segments"};
    cornell_lengths: phase 7's photon map lengths. Returns the launch
    counts of 14a's renders in the group of one (the counts set to 0 just
    before them and read just after) and the summed counts of 14b's
    ranks."""
    import tempfile

    import torch.distributed as dist

    from pathtracer_tpu_torch import film, ppm
    from pathtracer_tpu_torch.integrator import TILE, MeshRenderer, Renderer
    from pathtracer_tpu_torch.models import cornell, shirley
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk
    from pathtracer_tpu_torch.parallel import group
    from pathtracer_tpu_torch.parallel.mesh import (make_mesh,
                                                    make_sharded_render_fn)
    from pathtracer_tpu_torch.parallel.ppm_ring import make_ppm_mesh

    t_phase = time.perf_counter()
    os.makedirs(OUT, exist_ok=True)
    rdv = tempfile.mkdtemp(prefix="rdv_", dir=OUT)
    img4, segs4 = shirley_ref
    g_rend, img13, segs13 = pt_ref["rend"], pt_ref["image"], pt_ref["segments"]
    pt_scene, pt_cam, pt_mesh = g_rend.scene, g_rend.camera, g_rend.mesh
    pt_bg = shirley.BACKGROUND
    iters = 2  # the PPM renders' iterations

    def bands(make, height, sp, spp):
        """make(tile_row0, band)'s sp bands, stitched, through the film."""
        tyn = -(-height // TILE)
        band = -(-tyn // sp)
        parts = []
        for s in range(sp):
            r = make(s * band, band)
            parts.append(r.band_image(r.band_sums(range(spp))[0]))
        return film.finalize(film.apply_filter(torch.cat(parts)[:height],
                                               r.kern2d), spp)

    def ppm_in_group(scene, cam, lights, mesh, shard):
        return ppm.PPMRenderer(
            scene, cam, lights, PPM_SIZE, PPM_SIZE, iterations=iters,
            photon_count=PPM_PHOTONS, max_bounces=PPM_BOUNCES,
            verbose=False, mesh=mesh, group=pp.get_group("pp"),
            shard_photon_map=shard)

    # --- 14a. in this process: an NCCL group of one ------------------------
    t0 = time.perf_counter()
    group.init(dev.type, init_method=f"file://{rdv}/rendezvous", rank=0,
               world_size=1)
    backend = dist.get_backend()
    mesh, pp = make_mesh(1, 1, dev.type), make_ppm_mesh(dev.type)
    scene, cam, bg = shirley.build(WIDTH / HEIGHT, dev)
    c_scene, c_cam, c_lights = cornell.build(1.0, dev)
    sharded = make_sharded_render_fn(cam, bg, WIDTH, HEIGHT, SPP, BOUNCES,
                                     mesh, dev)
    sharded_pt = make_sharded_render_fn(pt_cam, pt_bg, PT_SIZE, PT_SIZE,
                                        PT_SPP, PT_BOUNCES, mesh, dev,
                                        scene_mesh=pt_mesh)
    # the group of one's replicated cornell map (bands of
    # ppm.GROUP_BAND_ROWS at any world size: 14b's two ranks must equal
    # it) and ganesha ring (one band, the whole image)
    rep1 = ppm_in_group(c_scene, c_cam, c_lights, None, False)
    ring1 = ppm_in_group(pt_scene, pt_cam, g_rend.lights, pt_mesh, "ring")
    (img, segs, img_pt, segs_pt, want_rep, want_g), launches, _ = counted(
        torch, dev, lambda: (*sharded(scene), *sharded_pt(pt_scene),
                             rep1.render().cpu(), ring1.render().cpu()))
    read_no_path("multi_device", launches)
    eq = {"shirley_world1": bool(torch.equal(img, img4)) and segs == segs4,
          "ganesha_pt_world1": (bool(torch.equal(img_pt, img13))
                                and segs_pt == segs13),
          "cornell_lengths": [int(n) for n in rep1.photon_map_lengths]
          == cornell_lengths[:iters]}
    for sp in (2, 4):
        eq[f"shirley_sp{sp}_bands"] = bool(torch.equal(bands(
            lambda row0, band: Renderer(
                scene, cam, bg, WIDTH, HEIGHT, SPP, BOUNCES, dev,
                tile_row0=row0, band_tile_rows=band), HEIGHT, sp, SPP),
            img4))
    eq["ganesha_pt_sp2_bands"] = bool(torch.equal(bands(
        lambda row0, band: MeshRenderer(
            pt_scene, pt_cam, pt_bg, PT_SIZE, PT_SIZE, PT_SPP, PT_BOUNCES,
            dev, pt_mesh, tile_row0=row0, band_tile_rows=band), PT_SIZE, 2,
        PT_SPP), img13))
    dist.destroy_process_group()
    # the tile kernel over band_tile_maps of the ganesha PPM table (19 tile
    # rows): tile rows 0-9, inside the image, and 10-19, whose row 19 lies
    # past it (the zero chunk), against its plain version on the same maps
    # and the band's primaries (NaN counted as equal)
    tt, tile = g_rend.tile_table, g_rend.tile_tensors(1)
    band_rows = 10 * TILE
    band_eq = {}
    for row0 in (0, 10):
        start, src = ttk.band_tile_maps(tt, row0, 10)
        maps = (tile[0], torch.from_numpy(start).to(dev),
                torch.from_numpy(src).to(dev))
        d = ppm.make_eye_pass(
            pt_cam, PPM_SIZE, PPM_SIZE, PPM_BOUNCES, PPM_PHOTONS, pt_scene,
            1, pt_mesh, maps, band_rows=band_rows,
            row0=row0 * TILE).primary(0)[2][:band_rows * PPM_SIZE]
        d = d.contiguous()
        got = ttk.intersect_tile_tris(*maps, d, PPM_SIZE)
        want = ttk.intersect_tile_tris_plain(*maps, d, PPM_SIZE)
        band_eq[f"tile_rows_{row0}_{row0 + 9}"] = dict(
            tiles=len(start) - 1, chunks=len(src),
            equal=all(bool(torch.equal(g.isnan(), w.isnan())
                           and torch.equal(g.nan_to_num(0), w.nan_to_num(0)))
                      for g, w in zip(got, want)),
            hits=int((got[0] < ttk.BIG).sum()))
    phase("multi_device_world1", backend=backend, equal=json.dumps(eq),
          tile_kernel_on_band_maps=json.dumps(band_eq),
          segments=segs, segments_ganesha_pt=segs_pt,
          launches=json.dumps(launches),
          seconds=f"{time.perf_counter() - t0:.3f}", gpu=json.dumps(smi))
    require(backend == ("nccl" if dev.type == "cuda" else "gloo"),
            f"world-1 group on {backend}")
    require(all(eq.values()), f"a world-1 or band render differs: {eq}")
    require(all(b["equal"] for b in band_eq.values()),
            f"the tile kernel differs on band maps: {band_eq}")
    require(all(n > 0 for n in launches.values()),
            f"a kernel did not run in the group of one: {launches}")

    # --- 14b. two gloo ranks on the one card -------------------------------
    # one spawn: the path tracer's splits, then cornell at 600x600 with the
    # replicated, sharded and ring maps (each rank's ring band 320 rows)
    # and the ganesha ring
    t0 = time.perf_counter()
    canon = dict(kind="pt", scene="shirley", width=WIDTH, height=HEIGHT,
                 spp=SPP, bounces=BOUNCES, renders=3)
    base = dict(kind="ppm", scene="cornell", width=PPM_SIZE,
                height=PPM_SIZE, iterations=iters, photons=PPM_PHOTONS,
                bounces=PPM_BOUNCES)
    out = group.spawn(
        "chip_smoke:rank_runs", 2, dev.type, "gloo", rdv,
        [dict(canon, dp=1, sp=2), dict(canon, dp=2, sp=1),
         dict(canon, scene="ganesha_pt", ply=GANESHA_PLY, width=PT_SIZE,
              height=PT_SIZE, spp=PT_SPP, bounces=PT_BOUNCES, dp=1, sp=2),
         dict(base, shard=False), dict(base, shard=True),
         dict(base, shard="ring"),
         dict(base, scene="ganesha", ply=GANESHA_PLY, shard="ring")])
    pt_out, ppm_out = out[:3], out[3:]
    (sp2, dp2, pt2) = pt_out
    eq = {"shirley_1x2": (bool(torch.equal(sp2["img"], img4.cpu()))
                          and sp2["segments"] == segs4),
          "shirley_2x1_segments": dp2["segments"] == segs4,
          "ganesha_pt_1x2": (bool(torch.equal(pt2["img"], img13.cpu()))
                             and pt2["segments"] == segs13)}
    dp_err = float((dp2["img"] - img4.cpu()).abs().max())
    phase("multi_device_ranks_pt", ranks=2, backend="gloo",
          equal=json.dumps(eq),
          shirley_2x1_max_abs_err=f"{dp_err:.3e}",
          walls_s=json.dumps({k: [[round(w, 4) for w in ws]
                                  for ws in o["walls"]]
                              for k, o in zip(("1x2", "2x1", "pt_1x2"),
                                              pt_out)}),
          launches=json.dumps({k: o["launches"] for k, o in
                               zip(("1x2", "2x1", "pt_1x2"), pt_out)}),
          gpu=json.dumps(smi))
    require(all(eq.values()) and dp_err <= 1e-5,
            f"a two-rank render differs: {eq}, dp max err {dp_err}")

    rep, host, ring, g_ring = ppm_out
    close = lambda a, b: bool(torch.allclose(a, b, atol=1e-6, rtol=1e-4))
    eq = {"replicated_world1": bool(torch.equal(rep["img"], want_rep)),
          "sharded_vs_replicated": close(host["img"], rep["img"]),
          "ring_vs_replicated": close(ring["img"], rep["img"]),
          "ganesha_ring_vs_world1": close(g_ring["img"], want_g),
          "lengths": all(o["photon_map_lengths"] == cornell_lengths[:iters]
                         for o in (rep, host, ring))}
    names = ("replicated", "sharded", "ring", "ganesha_ring")
    phase("multi_device_ranks_ppm", ranks=2, backend="gloo",
          equal=json.dumps(eq),
          max_abs_err=json.dumps({n: float((o["img"] - rep["img"]).abs()
                                           .max()) for n, o in
                                  zip(names[1:3], (host, ring))}),
          ganesha_ring_max_abs_err=float((g_ring["img"] - want_g).abs()
                                         .max()),
          photon_map_lengths=json.dumps(rep["photon_map_lengths"]),
          deposit_rows=json.dumps(rep["deposit_rows"]),
          ring_hop_ms=json.dumps({n: o["hop_ms"] for n, o in
                                  zip(names, ppm_out)}),
          walls_s=json.dumps({n: [round(w, 4) for w in o["walls"]]
                              for n, o in zip(names, ppm_out)}),
          launches=json.dumps({n: o["launches"]
                               for n, o in zip(names, ppm_out)}),
          seconds=f"{time.perf_counter() - t0:.3f}", gpu=json.dumps(smi))
    require(all(eq.values()), f"a two-rank photon map differs: {eq}")

    # --- 14c. the CLI under torchrun ---------------------------------------
    t0 = time.perf_counter()
    png = os.path.join(OUT, "cornell_ring_torchrun.png")
    if os.path.exists(png):
        os.remove(png)
    cli = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=1", "-m", "pathtracer_tpu_torch", "cornell-box",
         "-width", str(PPM_SIZE), "-height", str(PPM_SIZE), "-iterations",
         "2", "-shard-photon-map", "ring", "-no-progress", "-device",
         dev.type, "-o", png],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    require(cli.returncode == 0,
            f"torchrun CLI failed:\n{cli.stdout}\n{cli.stderr}")
    said = [ln for ln in cli.stdout.splitlines() if ln.startswith("backend")]
    size = png_size(png)
    phase("multi_device_torchrun", said=json.dumps(said),
          png=os.path.relpath(png, ROOT), size=f"{size[0]}x{size[1]}",
          seconds=f"{time.perf_counter() - t0:.3f}")
    require(size == (PPM_SIZE, PPM_SIZE), f"PNG is {size}")
    require(said and said[0].startswith("backend = nccl")
            or dev.type != "cuda",
            f"torchrun CLI backend: {said}")
    rank_launches = {}
    for o in out:
        for per_rank in o["launches"]:
            for k, n in per_rank.items():
                rank_launches[k] = rank_launches.get(k, 0) + n
    require(all(rank_launches.pop(k) == 0 for k in no_path_kernels()),
            f"a rank launched a kernel of no path: {rank_launches}")
    phase("multi_device", seconds=f"{time.perf_counter() - t_phase:.3f}")
    return launches, rank_launches


def subdivide(np, verts, faces):
    """4:1 midpoint subdivision: one new vertex per undirected edge, so a
    closed surface stays closed. Returns (vertices, 4 F faces)."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    n = len(verts)
    key = np.minimum(e[:, 0], e[:, 1]) * n + np.maximum(e[:, 0], e[:, 1])
    uniq, inv = np.unique(key, return_inverse=True)
    mids = 0.5 * (verts[uniq // n] + verts[uniq % n])
    m01, m12, m20 = (n + inv).reshape(3, -1)
    a, b, c = faces.T
    out = [np.stack(t, axis=1) for t in ((a, m01, m20), (m01, b, m12),
                                         (m20, m12, c), (m01, m12, m20))]
    return np.concatenate([verts, mids]), np.concatenate(out)


def image_shares(np, img, ref_img, size):
    """(RMSE as a share of the reference's RMS, the RMSE of 8x8-pixel means
    as a share of the means' RMS, max |difference|) of an image against its
    reference."""
    rmse = float(np.sqrt(np.mean((img - ref_img) ** 2)))
    binned = [x.reshape(size // 8, 8, size // 8, 8, 3).mean(axis=(1, 3))
              for x in (img, ref_img)]
    b_share = (float(np.sqrt(np.mean((binned[0] - binned[1]) ** 2)))
               / float(np.sqrt(np.mean(binned[1] ** 2))))
    return (rmse / float(np.sqrt(np.mean(ref_img ** 2))), b_share,
            float(np.abs(img - ref_img).max()))


def pt_render_gates(torch, np, dev, render, scene, name, renders):
    """The path-traced ganesha gates of phase 13 on one make_render_fn:
    a first render (set-up included), then `renders` warm ones, the first
    of them counted. Returns the phase fields and the counted launches."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render(scene)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    (img_t, segments), launches, wall = counted(torch, dev,
                                                lambda: render(scene))
    walls = [wall]
    for _ in range(renders - 1):
        walls.append(counted(torch, dev, lambda: render(scene))[2])
    ref = np.load(GANESHA_PT_REF)
    ref_img = ref["img"].astype(np.float64)
    img = img_t.cpu().numpy().astype(np.float64)
    require(img.shape == ref_img.shape and bool(np.isfinite(img).all()),
            f"{name}: image {img.shape}, finite {np.isfinite(img).all()}")
    ref_segs = int(ref["segments"])
    share, b_share, max_diff = image_shares(np, img, ref_img, PT_SIZE)
    seg_err = abs(segments - ref_segs) / ref_segs
    require(seg_err <= PT_SEGMENT_SLACK,
            f"{name}: segments {segments} vs the reference's {ref_segs}")
    require(share <= GANESHA_PT_RMSE_SHARE,
            f"{name}: RMSE share {share} > {GANESHA_PT_RMSE_SHARE}")
    require(b_share <= GANESHA_PT_BINNED_SHARE,
            f"{name}: 8x8-binned RMSE share {b_share} > "
            f"{GANESHA_PT_BINNED_SHARE}")
    return dict(segments=segments, reference_segments=ref_segs,
                segments_rel_err=f"{seg_err:.3e}",
                rmse_share_of_rms=f"{share:.4e}",
                binned8_rmse_share=f"{b_share:.4e}",
                max_abs_diff=f"{max_diff:.6e}",
                first_render_s=f"{first_s:.4f}",
                wall_s=f"{statistics.median(walls):.4f}",
                walls_s=json.dumps([round(w, 4) for w in walls])), launches


def held_ms(torch, fn, reps: int = 5, batch: int = 10) -> float:
    """Median device ms per call of fn: CUDA events around `batch` calls
    that the host enqueues while a device sleep holds the stream, so the
    events time the kernels back to back, not the host's launches.
    (torch.profiler, late in this process, now and then records none of
    the ctypes launches.) A turn counts only if the host finished
    enqueueing before the sleep ended, by the sleep's own events, with a
    fifth of it to spare; else the sleep doubles and the turn is taken
    again."""
    fn()
    torch.cuda.synchronize()
    cycles, times = 4_000_000, []  # ~2 ms at the H100's clocks
    while len(times) < reps:
        slept = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        slept.record()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if host_ms < 0.8 * slept.elapsed_time(start):
            times.append(start.elapsed_time(end) / batch)
        else:
            require(cycles < 1 << 30, f"held_ms: the host took {host_ms:.3f}"
                    " ms to enqueue, longer than any sleep tried")
            cycles *= 2
    return statistics.median(times)


def cache_counts(torch, bw, args, want) -> dict:
    """bvh4_walk_cached_plain on args, required equal to the plain walk's
    outputs `want`: the steps of csrc/bvh4_walk.cu per active lane as it
    takes them (table loads: the chain of dependent loads, mean and max;
    node rows at phase > 0 read from the path cache and not; leaf steps
    that test two rows), their sum (loads) and the share of returns the
    cache served."""
    *got, counts = bw.bvh4_walk_cached_plain(*args)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "bvh4_walk_cached_plain differs from bvh4_walk_plain")
    c = counts[args[4]]
    hits, misses, two = (int(x) for x in c[:, 1:].sum(dim=0))
    return dict(loads=int(c[:, 0].sum()),
                loads_mean=f"{float(c[:, 0].float().mean()):.2f}",
                loads_max=int(c[:, 0].max()), cache_hits=hits,
                cache_misses=misses, two_row_steps=two,
                served_from_cache=f"{hits / max(hits + misses, 1):.4f}")


def bvh4_walk_readings(torch, bw, name, args, args8=None, plain=False):
    """One ray set of phase 15: bvh4_walk against its plain version
    (required equal) with the plain walk's steps and bound (walk_work),
    the kernel's own steps (cache_counts), its counters (required equal to
    the active lanes and the emulation's loads), its CUDA-event ms (host
    cost included) and device ms (held_ms), counters on as MeshBVH runs
    it; with args8 (phase 9's BVH8 table,
    the same rays) bvh8_walk's ms beside it and the lanes whose hit, t or
    idx differ (required 0); with `plain` the plain version's ms. Prints
    the phase line; returns the set's record."""
    n = args[1].shape[0]
    t0 = time.perf_counter()
    want, fields, w_bound = walk_work(torch, bw, args, walk="bvh4")
    fields.update(plain_count_steps_s=f"{time.perf_counter() - t0:.3f}",
                  **cache_counts(torch, bw, args, want))
    counts = torch.zeros(2, dtype=torch.int64, device=args[1].device)
    got = bw.bvh4_walk(*args, counts)
    torch.cuda.synchronize()
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    want_counts = [int(args[4].sum()), fields["loads"]]
    require(counts.tolist() == want_counts,
            f"bvh4_walk ({name}): counts {counts.tolist()}, want "
            f"{want_counts} (active lanes, the emulation's loads)")
    kms = time_ms(torch, lambda: bw.bvh4_walk(*args, counts))
    dev_ms = held_ms(torch, lambda: bw.bvh4_walk(*args, counts))
    rec = dict(ms=kms, device_ms=dev_ms, bound_ms=w_bound["bound_ms"],
               bound_by=w_bound["bound_by"],
               steps_mean=float(fields["steps_mean"]),
               steps_max=fields["steps_max"],
               loads_mean=float(fields["loads_mean"]),
               loads_max=fields["loads_max"],
               served_from_cache=float(fields["served_from_cache"]))
    if plain:
        rec["err"] = 0.0 if exact else max(
            float((g.float() - w.float()).abs().max())
            for g, w in zip(got, want))
        rec["plain_ms"] = time_ms(torch, lambda: bw.bvh4_walk_plain(*args),
                                  reps=2, batch=1)
        fields["plain_ms"] = f"{rec['plain_ms']:.4f}"
    if args8 is not None:
        got8 = bw.bvh8_walk(*args8)
        rec["bvh8_ms"] = time_ms(torch, lambda: bw.bvh8_walk(*args8))
        rec["bvh8_device_ms"] = held_ms(torch, lambda: bw.bvh8_walk(*args8))
        differ = dict(hit=int((got[4] != got8[4]).sum()),
                      t=int((got[0] != got8[0]).sum()),
                      idx=int(((got[3] != got8[3]) & (got[4] | got8[4]))
                              .sum()))
        fields.update(bvh8_ms=f"{rec['bvh8_ms']:.4f}",
                      bvh8_device_ms=f"{rec['bvh8_device_ms']:.4f}",
                      lanes_differ_from_bvh8=json.dumps(differ))
        require(sum(differ.values()) == 0,
                f"bvh4_walk ({name}): lanes differ from bvh8_walk {differ}")
    phase("bvh4_walk", shape=f"{name}:{n}_lanes", equal=exact,
          ms=f"{kms:.4f}", device_ms=f"{dev_ms:.4f}",
          share_of_bound=f"{w_bound['bound_ms'] / dev_ms:.4f}",
          hits=int(got[4].sum()), bound_by=w_bound["bound_by"], **fields)
    require(exact, f"bvh4_walk ({name}): the kernel differs from its plain "
            "version")
    return rec


def bvh4_ray_sets(mesh, scene, cam, lights, dev, photons=True) -> dict:
    """The BVH4 walk's inputs on `mesh`, as the renders make them: the
    ganesha photon pass's bounces 0 and 1 (with `photons`) and the
    path-traced pass 0's bounces 1 and 3 (600x600, spp 8, 8 bounces)."""
    from pathtracer_tpu_torch import ppm
    from pathtracer_tpu_torch.integrator import MeshRenderer
    from pathtracer_tpu_torch.models import shirley

    sets = {}
    if photons:
        trace, _, _ = ppm.make_photon_pass(scene, lights, PPM_PHOTONS,
                                           PPM_BOUNCES, mesh)
        photon_in = recorded_walks(mesh, lambda: trace(0))
        sets.update(photon_b0=photon_in[0], photon_b1=photon_in[1])
    r = MeshRenderer(scene, cam, shirley.BACKGROUND, PT_SIZE, PT_SIZE,
                     PT_SPP, PT_BOUNCES, dev, mesh)
    pt_in = recorded_walks(mesh, lambda: r.trace_pass(0))
    sets.update(pt_b1=pt_in[0], pt_b3=pt_in[2])
    return sets


def bvh4_sub4_ply(np) -> tuple:
    """big_ganesha subdivided 4:1 (1,797,408 triangles, past the BVH8
    table's range), written to OUT: (its path, vertices, faces).
    The caller removes the 34 MB file."""
    from pathtracer_tpu_torch.io import ply

    p = ply.load(GANESHA_PLY)
    verts = np.stack([np.asarray(p.data["vertex"][k], np.float64)
                      for k in "xyz"], axis=1)
    verts, faces = subdivide(np, verts, np.asarray(
        p.data["vertex_indices"]["vertex_indices"], np.int64))
    verts = verts.astype(np.float32).astype(np.float64)  # as the file holds
    os.makedirs(OUT, exist_ok=True)
    sub_ply = os.path.join(OUT, "big_ganesha_sub4.ply")
    ply.write_mesh(sub_ply, verts, faces)
    return sub_ply, verts, faces


def bvh4_phases(torch, np, dev, smi, rend):
    """Phase 15: the BVH4 walk. (a) phase 9's triangles on the BVH4 table:
    bvh4_walk against its plain version and beside bvh8_walk on four ray
    sets (bvh4_walk_readings), and the ganesha PPM and path-traced renders
    through it; (b) big_ganesha subdivided 4:1 (1,797,408 triangles), past
    the BVH8 table's range, through build_pt, bvh4_walk on two ray sets,
    the path-traced render and the ganesha CLI. rend: phase 9's
    PPMRenderer (its mesh on the BVH8 table). Returns (the JSON entry of
    bvh4_walk without launches, {render path: launches})."""
    import functools
    from unittest import mock

    from pathtracer_tpu_torch import native, ppm
    from pathtracer_tpu_torch.integrator import make_render_fn
    from pathtracer_tpu_torch.models import ganesha, shirley
    from pathtracer_tpu_torch.ops.bvh import MeshBVH, build_walk_table4
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk

    t_phase = time.perf_counter()
    mesh8 = rend.mesh
    bg = shirley.BACKGROUND
    path_launches = {}

    def off_path(name, launches, want=None):
        """Phase 15's renders take the BVH4 walk: it ran, the BVH8 walk and
        the kernels of no path did not (and, with `want`, every count)."""
        path_launches[name] = launches
        require(launches["bvh4_walk"] > 0 and launches["bvh8_walk"] == 0
                and launches["intersect_clustered"] == 0
                and launches["gather_flux"] == 0,
                f"{name}: launches {launches}")
        require(want is None or launches == want,
                f"{name}: launches {launches}, want {want}")

    # --- 15a. phase 9's triangles on the BVH4 table ------------------------
    t0 = time.perf_counter()
    with mock.patch.object(ganesha, "MeshBVH",
                           functools.partial(MeshBVH, walk="bvh4")):
        scene, cam, lights, mesh = ganesha.build(GANESHA_PLY, 1.0, dev)
    build_s = time.perf_counter() - t0
    phase("bvh4_mesh", triangles=mesh.n_tris, walk=mesh.walk,
          walk_table_rows=mesh.table_np.shape[0], node_end=mesh.node_end,
          stride=mesh.stride, table_mb=f"{mesh.table_np.nbytes / 1e6:.1f}",
          bvh8_table_rows=mesh8.table_np.shape[0],
          mesh_build_s=f"{build_s:.3f}")
    require(mesh.walk == "bvh4" and np.array_equal(mesh.tri_a, mesh8.tri_a),
            "the BVH4 mesh holds other triangles than phase 9's")

    # the walk on its ray sets, beside bvh8_walk on the same rays
    walk = {}
    for name, rays in bvh4_ray_sets(mesh, scene, cam, lights, dev).items():
        walk[name] = bvh4_walk_readings(
            torch, bw, name, (mesh.table, *rays, mesh.node_end, mesh.stride),
            (mesh8.table, *rays, mesh8.node_end, mesh8.stride),
            plain=name == "photon_b0")

    # the ganesha PPM render on the BVH4 table, phase 11's gates
    rend4 = ppm.PPMRenderer(scene, cam, lights, PPM_SIZE, PPM_SIZE,
                            iterations=PPM_ITERS, photon_count=PPM_PHOTONS,
                            max_bounces=PPM_BOUNCES, verbose=False,
                            mesh=mesh)
    marks = []

    def tick(i, img_sum):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    t0 = time.perf_counter()
    img_sum, launches, _ = counted(
        torch, dev, lambda: rend4.render(checkpoint_cb=tick))
    off_path("ganesha_bvh4", launches)
    require(all(launches[k] > 0 for k in (
        "intersect_spheres", "intersect_tris", "gather_flux_chunks",
        "intersect_tile_tris")), f"ganesha on BVH4: launches {launches}")
    iter_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    lengths = [int(n) for n in rend4.photon_map_lengths]
    ref = np.load(GANESHA_REF)
    ref_len = [int(n) for n in ref["photon_map_lengths"]]
    len_err = max(abs(a - b) / b for a, b in zip(lengths, ref_len))
    img = img_sum.cpu().numpy() / PPM_ITERS
    ref_img = ref["img"].astype(np.float64)
    require(img.shape == ref_img.shape and bool(np.isfinite(img).all()),
            f"ganesha on BVH4: image {img.shape}")
    share, b_share, max_diff = image_shares(np, img, ref_img, PPM_SIZE)
    phase("bvh4_ganesha_render",
          config=f"{PPM_SIZE}x{PPM_SIZE},iters={PPM_ITERS},"
                 f"photons={PPM_PHOTONS},b={PPM_BOUNCES}",
          first_iter_s=f"{iter_s[0]:.4f}",
          median_s_per_iter=f"{statistics.median(iter_s[1:]):.4f}",
          bvh8_phase11=json.dumps({k: round(v, 4) for k, v in
                                   MESH_WALLS["ganesha"].items()}),
          photon_map_lengths=json.dumps(lengths),
          max_length_rel_err=f"{len_err:.3e}",
          rmse_share_of_rms=f"{share:.4e}",
          binned8_rmse_share=f"{b_share:.4e}", max_abs_diff=f"{max_diff:.6e}",
          launches=json.dumps(launches), gpu=json.dumps(smi))
    require(len_err <= PPM_LENGTH_SLACK,
            f"ganesha on BVH4: photon map lengths {lengths} vs {ref_len}")
    require(share <= GANESHA_RMSE_SHARE,
            f"ganesha on BVH4: RMSE share {share} > {GANESHA_RMSE_SHARE}")
    require(b_share <= GANESHA_BINNED_SHARE,
            f"ganesha on BVH4: 8x8-binned RMSE share {b_share} > "
            f"{GANESHA_BINNED_SHARE}")

    # the path-traced ganesha on the BVH4 table, phase 13's gates
    want_pt = {k: 0 for k in launches}
    want_pt.update(intersect_spheres=PT_SPP * PT_BOUNCES,
                   intersect_tris=PT_SPP * PT_BOUNCES,
                   bvh4_walk=PT_SPP * (PT_BOUNCES - 1),
                   intersect_tile_tris=PT_SPP,
                   winner_t=PT_SPP * PT_BOUNCES,
                   mesh_bounce=PT_SPP * PT_BOUNCES)
    fields, launches = pt_render_gates(
        torch, np, dev, make_render_fn(cam, bg, PT_SIZE, PT_SIZE, PT_SPP,
                                       PT_BOUNCES, dev, mesh=mesh),
        scene, "ganesha_pt on BVH4", PT_WARM_RENDERS)
    off_path("ganesha_pt_bvh4", launches, want_pt)
    phase("bvh4_ganesha_pt_render",
          config=f"{PT_SIZE}x{PT_SIZE},spp={PT_SPP},b={PT_BOUNCES}",
          bvh8_phase13=json.dumps({k: round(v, 4) for k, v in
                                   MESH_WALLS["ganesha_pt"].items()}),
          launches=json.dumps(launches), gpu=json.dumps(smi), **fields)

    # --- 15b. a mesh past the BVH8 table's range ---------------------------
    sub_ply, verts, faces = bvh4_sub4_ply(np)
    t0 = time.perf_counter()
    scene_b, cam_b, _, mesh_b = ganesha.build_pt(sub_ply, 1.0, dev)
    build_pt_s = time.perf_counter() - t0
    require(mesh_b.walk == "bvh4" and mesh_b.n_tris == len(faces),
            f"build_pt of {len(faces)} triangles took {mesh_b.walk}")
    # the build's steps timed alone on the same triangles, and the BVH8
    # table's refusal (sized from the tree before any allocation)
    vc = cam_b.transform_points(verts).astype(np.float32)
    a, b, c = (vc[faces[:, k]] for k in range(3))
    t0 = time.perf_counter()
    nodes_lo, nodes_hi, meta, order, _, axes = native.bvh_build(
        np.minimum(np.minimum(a, b), c), np.maximum(np.maximum(a, b), c))
    bvh_s = time.perf_counter() - t0
    a, b, c = a[order], b[order], c[order]
    tables = (nodes_lo, nodes_hi, meta, axes, a, b - a, c - a)
    t0 = time.perf_counter()
    table4 = build_walk_table4(*tables)[0]
    table_s = time.perf_counter() - t0
    refused = None
    try:
        native.bvh8_table(*tables)
    except ValueError as e:
        refused = str(e)
    require(refused is not None and "24-bit" in refused,
            f"the BVH8 table took {len(faces)} triangles")
    require(table4.shape == mesh_b.table_np.shape,
            f"the BVH4 table alone has {table4.shape[0]} rows, build_pt's "
            f"{mesh_b.table_np.shape[0]}")
    del table4
    t0 = time.perf_counter()
    ttk.build_tile_tri_table(cam_b, mesh_b.tri_a, mesh_b.tri_e1,
                             mesh_b.tri_e2, PT_SIZE, PT_SIZE, bvh=mesh_b,
                             backface_cull=mesh_b.watertight, flip_y=True)
    tile_s = time.perf_counter() - t0
    phase("bvh4_past_range_mesh", triangles=mesh_b.n_tris,
          ply=os.path.relpath(sub_ply, ROOT), walk=mesh_b.walk,
          bvh8_refused=json.dumps(refused), bvh8_row_limit=2 ** 24 // 8,
          walk_table_rows=mesh_b.table_np.shape[0], node_end=mesh_b.node_end,
          stride=mesh_b.stride,
          table_mb=f"{mesh_b.table_np.nbytes / 1e6:.1f}",
          build_pt_s=f"{build_pt_s:.3f}", bvh_build_s=f"{bvh_s:.3f}",
          walk_table_s=f"{table_s:.3f}", tile_table_s=f"{tile_s:.3f}")
    # the walk on the path-traced pass 0's rays on this mesh
    for name, rays in bvh4_ray_sets(mesh_b, scene_b, cam_b, None, dev,
                                    photons=False).items():
        walk[f"sub4_{name}"] = bvh4_walk_readings(
            torch, bw, f"sub4_{name}",
            (mesh_b.table, *rays, mesh_b.node_end, mesh_b.stride))
    fields, launches = pt_render_gates(
        torch, np, dev, make_render_fn(cam_b, bg, PT_SIZE, PT_SIZE, PT_SPP,
                                       PT_BOUNCES, dev, mesh=mesh_b),
        scene_b, "ganesha_pt past the BVH8 range", 1)
    off_path("ganesha_pt_sub4", launches, want_pt)
    # the counted render's walk counters: every live lane past bounce 0
    rays, loads = mesh_b.walk_counts.tolist()
    primaries = PT_SIZE * PT_SIZE * PT_SPP
    require(rays == fields["segments"] - primaries and loads > rays,
            f"ganesha_pt_sub4: walk counters {rays} rays, {loads} loads; "
            f"want {fields['segments'] - primaries} rays, more loads")
    fields.update(walk_rays=rays, walk_loads_per_ray=f"{loads / rays:.4f}")
    phase("bvh4_past_range_pt_render",
          config=f"{PT_SIZE}x{PT_SIZE},spp={PT_SPP},b={PT_BOUNCES}",
          launches=json.dumps(launches), gpu=json.dumps(smi), **fields)
    del scene_b, mesh_b

    # the ganesha CLI on the file: a render (with its progress lines, which
    # carry the photon map lengths) and -stop-after-bvh
    png = os.path.join(OUT, f"ganesha_sub4_{PPM_SIZE}x{PPM_SIZE}.png")
    if os.path.exists(png):
        os.remove(png)
    ply_arg = os.path.relpath(sub_ply, ROOT)
    said = {}
    for label, argv in (
            ("render", ["-width", str(PPM_SIZE), "-height", str(PPM_SIZE),
                        "-iterations", "2", "-photon-count",
                        str(PPM_PHOTONS), "-max-bounces", str(PPM_BOUNCES),
                        "-o", png]),
            ("stop_after_bvh", ["-stop-after-bvh"])):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "pathtracer_tpu_torch",
                              "ganesha", "-ganesha-ply", ply_arg, *argv],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        require(run.returncode == 0,
                f"ganesha CLI ({label}) on {ply_arg} failed:\n{run.stdout}"
                f"\n{run.stderr}")
        said[label] = (time.perf_counter() - t0, run.stdout.splitlines())
    os.remove(sub_ply)  # 34 MB: kept out of what the run brings back
    cli_lengths = [int(ln.split("=")[1].split()[0])
                   for ln in said["render"][1]
                   if ln.strip().startswith("photon map length =")]
    png_wh = png_size(png)
    stats = said["stop_after_bvh"][1]
    phase("bvh4_past_range_cli", seconds=f"{said['render'][0]:.3f}",
          png=os.path.relpath(png, ROOT), size=f"{png_wh[0]}x{png_wh[1]}",
          photon_map_lengths=json.dumps(cli_lengths),
          reference_lengths=json.dumps(ref_len[:2]),
          said=json.dumps(said["render"][1][-1]),
          stop_after_bvh_s=f"{said['stop_after_bvh'][0]:.3f}",
          stats=json.dumps([ln for ln in stats if ln.startswith(
              ("#triangles", "tree depth", "build time", "bvh bytes"))]))
    require(png_wh == (PPM_SIZE, PPM_SIZE), f"PNG is {png_wh}")
    require(len(cli_lengths) == 2, f"the CLI printed lengths {cli_lengths}")
    require(f"#triangles = {len(faces)}" in stats
            and stats[-1] == "Stop after bvh build",
            f"-stop-after-bvh said {stats}")
    phase("bvh4", seconds=f"{time.perf_counter() - t_phase:.3f}")

    b0 = walk["photon_b0"]
    kernel = entry(
        "bvh4_walk", "bvh4_walk.cu", "bvh.py:1038", b0["err"], b0["ms"],
        b0["plain_ms"], **{k: b0[k] for k in ("bound_ms", "bound_by")},
        shape="ganesha photon bounce-0 rays on the BVH4 table, 75776 lanes",
        lanes_per_ray=bw.BVH4_LANES_PER_RAY,
        cache_rows=bw.BVH4_CACHE_ROWS, device_ms=b0["device_ms"],
        bvh8_walk_ms=b0["bvh8_ms"], bvh8_walk_device_ms=b0["bvh8_device_ms"],
        **{f"{key}_{name}": w[key] for name, w in walk.items()
           if name != "photon_b0"
           for key in ("ms", "device_ms", "bound_ms", "bound_by",
                       "bvh8_ms", "bvh8_device_ms") if key in w},
        **{key: {name: w[key] for name, w in walk.items()}
           for key in ("steps_mean", "steps_max", "loads_mean", "loads_max",
                       "served_from_cache")})
    return kernel, path_launches


def seed_bounce_chain(torch, r, hier):
    """Phase 16a: the fused bounce at every bounce of pass 0 of Renderer
    `r` against its plain version, on the kernel's own state of the bounce
    before, compacted before bounce 3 as the render does (the wavefront
    keeps its width, its dead rows after the live ones), and that
    compaction against its plain version; each must be equal. Bounce 0
    runs the listed variant over r's tile lists, the others the full one
    over the sphere hierarchy `hier`. Returns (live lanes entering each
    bounce, the state entering bounce 1)."""
    from pathtracer_tpu_torch.integrator import _default_compact_at
    from pathtracer_tpu_torch.ops.cuda import compact_kernel as ck
    from pathtracer_tpu_torch.ops.cuda import fused_bounce_kernel as fbk

    bg_mode, colors = r.background
    state, off = r.initial_wavefront(0)
    live, state1 = [], None
    for b in range(r.max_bounces):
        if b in _default_compact_at(r.max_bounces):
            got = ck.compact_blocks(state, off)
            want = ck.compact_blocks_plain(state, off)
            torch.cuda.synchronize()
            exact = (torch.equal(got[0].view(torch.int32),
                                 want[0].view(torch.int32))
                     and torch.equal(got[1], want[1])
                     and torch.equal(got[2], want[2]))
            phase("shirley_seed_compact", bounce=b,
                  live=int((state[9] > 0).sum()), bit_identical=exact)
            require(exact, "seed scene: compact_blocks differs from its "
                    "plain version")
            state, off, n_used = ck.pack_rows(*got)
            require(int(n_used) > 0,
                    f"seed scene: no live lane before bounce {b}")
        if b == 1:
            state1 = state
        live.append(int((state[9] > 0).sum()))
        limbs = r.sampler.limbs(2 + 2 * b, 3 + 2 * b)
        kw = dict(bg_mode=bg_mode, origin_zero=b == 0,
                  block_lists=(r.lists, r.counts) if b == 0 else None,
                  sphere_bvh=None if b == 0 else hier)
        st_k, rad_k = fbk.fused_bounce(
            r.sph_table, state, r.pack_table, off, limbs, colors,
            torch.zeros(3, *state.shape[1:], device=state.device), **kw)
        st_p, rad_p = fbk.fused_bounce_plain(
            r.sph_table, state, r.pack_table, off, limbs, colors,
            torch.zeros(3, *state.shape[1:], device=state.device), **kw)
        torch.cuda.synchronize()
        flips = int(((st_k[9] > 0) != (st_p[9] > 0)).sum())
        require(torch.equal(st_k, st_p) and torch.equal(rad_k, rad_p),
                f"seed scene, bounce {b}: fused_bounce differs from its "
                f"plain version ({flips} alive flags, state "
                f"{float((st_k - st_p).abs().max())})")
        state = st_k
    return live, state1


def seed_render_gates(np, img_t, segments, oracle_path, what, slack):
    """The image of a shirley render against its float64 oracle: finite, of
    the oracle's shape, RMSE below RMSE_BUDGET, segments within `slack` of
    the oracle's. Returns (rmse, the oracle's segments)."""
    oracle = np.load(oracle_path)
    img = img_t.cpu().numpy().astype(np.float64)
    require(img.shape == oracle["img"].shape and bool(np.isfinite(img).all()),
            f"{what}: image {img.shape}, finite {np.isfinite(img).all()}")
    rmse = float(np.sqrt(np.mean((img - oracle["img"]) ** 2)))
    want = int(oracle["segments"])
    require(rmse < RMSE_BUDGET, f"{what}: RMSE {rmse} >= {RMSE_BUDGET}")
    require(abs(segments - want) <= slack,
            f"{what}: segments {segments} vs the oracle's {want}")
    return rmse, want


def seed_phases(torch, np, dev, smi, canonical_wall_s):
    """Phase 16: (a) shirley_seed, the seed-7 scene of
    models.shirley.build(seed=7, use_manifest=False): its sphere hierarchy,
    the fused bounce at every bounce of pass 0 and the compaction against
    their plain versions (seed_bounce_chain), intersect_clustered against
    its plain version and intersect_spheres on its bounce-1 rays, and the
    canonical render of it through make_render_fn against its float64
    oracle; (b) shirley_scene_switch, one make_render_fn rendering seed 42,
    seed 7, then seed 42 again, each equal to a fresh render function's;
    (c) shirley_b16, the seed-42 scene at 16 bounces against its float64
    oracle, then bench.py's HQ render (spp 512) with its segments beside
    the TPU's. canonical_wall_s: phase 4's median wall. Returns {render
    path: launches}: only fused_bounce and compact_blocks may run."""
    from pathtracer_tpu_torch.integrator import Renderer, make_render_fn
    from pathtracer_tpu_torch.models import shirley
    from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk

    t_phase = time.perf_counter()
    path_launches = {}

    def on_path(name, launches):
        """A shirley render runs the fused bounce and the compaction and no
        other kernel: the kernels of no path, and those of the PPM and mesh
        paths, read 0."""
        require(launches["fused_bounce"] > 0 and launches["compact_blocks"] > 0
                and all(n == 0 for k, n in launches.items()
                        if k not in ("fused_bounce", "compact_blocks")),
                f"{name}: launches {launches}")
        return launches

    # --- 16a. the seed-7 scene ---------------------------------------------
    scene, cam, bg = shirley.build(WIDTH / HEIGHT, dev, seed=SEED,
                                   use_manifest=False)
    n_sph = int(scene.valid.sum())
    r = Renderer(scene, cam, bg, WIDTH, HEIGHT, SPP, BOUNCES, dev)
    t0 = time.perf_counter()
    hier = r.sphere_hierarchy()
    build_ms = (time.perf_counter() - t0) * 1e3
    require(n_sph == int(np.load(SEED_ORACLE)["spheres"]),
            f"seed {SEED}: {n_sph} spheres, the oracle's "
            f"{int(np.load(SEED_ORACLE)['spheres'])}")
    live, state1 = seed_bounce_chain(torch, r, hier)
    tables = sk.pack_spheres_clustered(scene.center, scene.radius,
                                       scene.valid)
    walk = sk.cached_cluster_walk(tables)
    k = tables[1].shape[1]
    org = state1[0:3].reshape(3, -1).T.contiguous()
    d = state1[3:6].reshape(3, -1).T.contiguous()
    alive = state1[9].reshape(-1) > 0
    err, cl_ms, cl_plain_ms, _ = compare(
        torch, "shirley_seed_clustered",
        lambda: sk.intersect_clustered(tables, org, d, alive),
        lambda: sk.intersect_clustered_plain(tables, org, d, alive),
        f"bounce1:{org.shape[0]}_rays", kernel="intersect_clustered_kernel",
        plain_reps=1, plain_batch=1, plain_prof=1, clusters=k,
        real_slots=walk.n_real,
        smem_bytes=sk.clustered_smem_bytes(k, walk.n_real))
    got = sk.intersect_clustered(tables, org, d, alive)
    want = sk.intersect_spheres(r.sph_table, org, d, alive)
    require(torch.equal(got[2][alive], want[2][alive])
            and torch.equal(got[0][alive], want[0][alive]),
            "seed scene: intersect_clustered's hits differ from "
            "intersect_spheres'")
    phase("shirley_seed", seed=SEED, spheres=n_sph, padded=scene.count,
          unconditional=hier.n_uncond, groups=hier.n_groups,
          leaves=hier.nodes.shape[0] - hier.n_groups,
          build_ms=f"{build_ms:.3f}", list_width=r.lists.shape[1],
          live_by_bounce=json.dumps(live), fused_bounce_equal=True,
          clustered_equal=True, clustered_hits_equal_spheres=True)

    render = make_render_fn(cam, bg, WIDTH, HEIGHT, SPP, BOUNCES, dev)
    t0 = time.perf_counter()
    render(scene)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    (img_t, segments), launches, wall = counted(torch, dev,
                                                lambda: render(scene))
    path_launches["shirley_seed7"] = on_path("shirley_seed7", launches)
    rmse, want_segs = seed_render_gates(np, img_t, segments, SEED_ORACLE,
                                        f"seed {SEED} render", SEGMENT_SLACK)
    walls = [wall] + [counted(torch, dev, lambda: render(scene))[2]
                      for _ in range(4)]
    wall_s = statistics.median(walls)
    phase("shirley_seed_render",
          config=f"{WIDTH}x{HEIGHT},spp={SPP},b={BOUNCES},seed={SEED}",
          segments=segments, oracle_segments=want_segs, rmse=f"{rmse:.6e}",
          first_render_s=f"{first_s:.4f}", wall_s=f"{wall_s:.4f}",
          walls_s=json.dumps([round(w, 4) for w in walls]),
          canonical_wall_s=f"{canonical_wall_s:.4f}",
          mrays_per_s=f"{segments / wall_s / 1e6:.3f}",
          launches=json.dumps({k: n for k, n in launches.items() if n}),
          gpu=json.dumps(smi))

    # --- 16b. one render function over three scenes ------------------------
    s42 = shirley.build(SWITCH_W / SWITCH_H, dev)[0]
    s7 = shirley.build(SWITCH_W / SWITCH_H, dev, seed=SEED,
                       use_manifest=False)[0]
    cam_s = shirley.make_camera(SWITCH_W / SWITCH_H)
    switch = make_render_fn(cam_s, bg, SWITCH_W, SWITCH_H, SWITCH_SPP,
                            BOUNCES, dev)
    sums, equal = {}, []
    for name, sc in (("seed42", s42), (f"seed{SEED}", s7), ("seed42", s42)):
        (img_s, segs_s), launches, _ = counted(torch, dev,
                                               lambda: switch(sc))
        on_path("shirley_scene_switch", launches)
        sums = {k: sums.get(k, 0) + n for k, n in launches.items()}
        img_f, segs_f = make_render_fn(cam_s, bg, SWITCH_W, SWITCH_H,
                                       SWITCH_SPP, BOUNCES, dev)(sc)
        equal.append((name, segs_s, torch.equal(img_s, img_f)
                      and segs_s == segs_f))
    path_launches["shirley_scene_switch"] = sums
    phase("shirley_scene_switch",
          config=f"{SWITCH_W}x{SWITCH_H},spp={SWITCH_SPP},b={BOUNCES}",
          renders=json.dumps(equal),
          launches=json.dumps({k: n for k, n in sums.items() if n}))
    require(all(e for _, _, e in equal),
            f"a scene switch's render differs from a fresh one: {equal}")
    require(equal[0][1] != equal[1][1],
            "the two scenes traced the same segments")

    # --- 16c. 16 bounces: the compaction at (2, 4) ---------------------------
    scene, cam, bg = shirley.build(WIDTH / HEIGHT, dev)
    render = make_render_fn(cam, bg, WIDTH, HEIGHT, SPP, B16, dev)
    render(scene)
    (img_t, segments), launches, wall = counted(torch, dev,
                                                lambda: render(scene))
    path_launches["shirley_b16"] = on_path("shirley_b16", launches)
    want_segs = int(np.load(B16_ORACLE)["segments"])
    rmse, _ = seed_render_gates(np, img_t, segments, B16_ORACLE,
                                "16-bounce render",
                                B16_SEGMENT_SLACK * want_segs)
    phase("shirley_b16", config=f"{WIDTH}x{HEIGHT},spp={SPP},b={B16}",
          segments=segments, oracle_segments=want_segs, rmse=f"{rmse:.6e}",
          wall_s=f"{wall:.4f}", mrays_per_s=f"{segments / wall / 1e6:.3f}",
          launches=json.dumps({k: n for k, n in launches.items() if n}))
    hq = make_render_fn(cam, bg, WIDTH, HEIGHT, HQ_SPP, B16, dev)
    (img_t, segments), launches, first = counted(torch, dev,
                                                 lambda: hq(scene))
    path_launches["shirley_hq"] = on_path("shirley_hq", launches)
    img = img_t.cpu().numpy()
    require(img.shape == (HEIGHT, WIDTH, 3) and bool(np.isfinite(img).all()),
            f"HQ render: image {img.shape}")
    wall = counted(torch, dev, lambda: hq(scene))[2]
    phase("shirley_hq", config=f"{WIDTH}x{HEIGHT},spp={HQ_SPP},b={B16}",
          segments=segments, tpu_segments=HQ_TPU_SEGMENTS,
          first_render_s=f"{first:.4f}", wall_s=f"{wall:.4f}",
          mrays_per_s=f"{segments / wall / 1e6:.3f}",
          launches=json.dumps({k: n for k, n in launches.items() if n}),
          gpu=json.dumps(smi))
    require(abs(segments - HQ_TPU_SEGMENTS)
            <= HQ_SEGMENT_SLACK * HQ_TPU_SEGMENTS,
            f"HQ segments {segments} vs the TPU's {HQ_TPU_SEGMENTS}")
    phase("seed", seconds=f"{time.perf_counter() - t_phase:.3f}")
    return path_launches


def entry(name, source, replaces, err, kms, pms, **kw):
    """One kernel of the JSON line; no single PyTorch call computes any of
    the port's kernels, so library_ms is null throughout."""
    return dict(name=name, route="cuda",
                source="pathtracer_tpu_torch/csrc/" + source,
                replaces="pathtracer_tpu/ops/" + replaces, max_abs_err=err,
                ms=kms, plain_ms=pms, library_ms=None, **kw)


def sweep_seg() -> None:
    """The chunk gather's device ms at each SEG of SWEEP_SEGS, on cornell
    iteration 1's eye hits at r(1) as phase 6 makes them: per setting, the
    profiler's ms per call over 5 calls, taken twice (the settings in
    order, then in reverse). At each SEG the kernel must equal its plain
    version on the 4 blocks with the longest lists. Prints one JSON line
    with the card's name and power limit."""
    import torch

    from pathtracer_tpu_torch import ppm
    from pathtracer_tpu_torch.models import cornell
    from pathtracer_tpu_torch.ops.cuda import gather_kernel as gk

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    size, photons, bounces = PPM_SIZE, PPM_PHOTONS, PPM_BOUNCES
    scene, cam, lights = cornell.build(1.0, dev)
    trace, _, _ = ppm.make_photon_pass(scene, lights, photons, bounces)
    eye = ppm.make_eye_pass(cam, size, size, bounces, photons, scene)
    r1 = ppm.PPMRenderer(scene, cam, lights, size, size,
                         photon_count=photons, max_bounces=bounces,
                         verbose=False).radius(1)
    pos, nrm, flux, ok, _ = trace(0)
    photons_t, sbox = gk.build_photon_chunks(pos, nrm, flux, ok)
    pt, nm, _, act = eye.walk(0)
    perm = torch.argsort(gk.hit_morton_keys(pt, act), stable=True)
    pt, nm, act = pt[perm].contiguous(), nm[perm].contiguous(), act[perm]
    _, counts = gk.block_chunk_lists(pt, act, sbox, r1)
    top = torch.argsort(counts, descending=True, stable=True)[:4].tolist()
    rows = torch.cat([torch.arange(b * 1024, (b + 1) * 1024, device=dev)
                      for b in sorted(top)])
    sub = (pt[rows].contiguous(), nm[rows].contiguous(), act[rows], sbox,
           photons_t, r1)
    args = (pt, nm, act, sbox, photons_t, r1)
    shipped, by_seg = gk.SEG, {}
    for seg in SWEEP_SEGS + SWEEP_SEGS[::-1]:
        gk.SEG = seg
        if seg not in by_seg:
            require(torch.equal(gk.gather_flux_chunks(*sub),
                                gk.gather_flux_chunks_plain(*sub)),
                    f"the gather at SEG {seg} differs from its plain version")
            by_seg[seg] = dict(items=int(gk.block_items(counts)[-1]),
                               device_ms=[])
        _, per, _, _ = device_times(
            torch, lambda: gk.gather_flux_chunks(*args), reps=5)
        by_seg[seg]["device_ms"].append(kernel_ms(per, "gather_chunks_"))
    gk.SEG = shipped
    print(json.dumps({"gpu": nvidia_smi(), "shipped_seg": shipped,
                      "list_max": int(counts.max()),
                      "list_mean": float(counts.float().mean()),
                      "by_seg": by_seg}))


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
    from pathtracer_tpu_torch.integrator import (Renderer, _default_compact_at,
                                                 make_render_fn)
    from pathtracer_tpu_torch.models import shirley
    from pathtracer_tpu_torch.ops.cuda import compact_kernel as ck
    from pathtracer_tpu_torch.ops.cuda import fused_bounce_kernel as fbk
    from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk

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
    # the sphere hierarchy, host work: its first build (which may build the
    # native library) and a second one, which a render pays once per scene
    t0 = time.perf_counter()
    hier = r.sphere_hierarchy()
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    sk.build_sphere_bvh(r.sph_table)
    build_ms = (time.perf_counter() - t0) * 1e3
    n_nodes = hier.nodes.shape[0]
    phase("sphere_bvh", spheres=int(scene.valid.sum()),
          unconditional=hier.n_uncond, groups=hier.n_groups,
          leaves=n_nodes - hier.n_groups,
          first_build_ms=f"{first_ms:.3f}", build_ms=f"{build_ms:.3f}")

    def bounce(fn, state, off_b, b):
        return fn(r.sph_table, state, r.pack_table, off_b,
                  r.sampler.limbs(2 + 2 * b, 3 + 2 * b), colors,
                  torch.zeros(3, *state.shape[1:], device=dev),
                  bg_mode=bg_mode, origin_zero=(b == 0),
                  block_lists=lists if b == 0 else None,
                  sphere_bvh=None if b == 0 else hier)

    # every bounce of pass 0 as the render runs it: bounce 0 listed, the
    # rest full (the per-warp walk of the sphere hierarchy), compacted
    # before bounce 3 over all 1,520 rows (the dead ones after the live
    # ones); each on the kernel's own state of the bounce before
    n_sph = int(scene.valid.sum())
    fb_err = 0.0
    fb_times, fb_in, fb_cull, fb_dev = {}, {}, {}, {}
    state_in, off_b = state0, off
    for b in range(BOUNCES):
        if b in _default_compact_at(BOUNCES):
            ck_in = (state_in, off_b)
            ck_k = ck.compact_blocks(*ck_in)
            ck_p = ck.compact_blocks_plain(*ck_in)
            torch.cuda.synchronize()
            exact = (torch.equal(ck_k[0].view(torch.int32),
                                 ck_p[0].view(torch.int32))
                     and torch.equal(ck_k[1], ck_p[1])
                     and torch.equal(ck_k[2], ck_p[2]))
            ck_err = max(float((ck_k[0] - ck_p[0]).abs().max()),
                         float((ck_k[1] - ck_p[1]).abs().max()))
            ck_ms = time_ms(torch, lambda: ck.compact_blocks(*ck_in))
            ck_plain_ms = time_ms(torch,
                                  lambda: ck.compact_blocks_plain(*ck_in))
            _, per, _, _ = device_times(
                torch, lambda: ck.compact_blocks(*ck_in))
            pdev, _, _, _ = device_times(
                torch, lambda: ck.compact_blocks_plain(*ck_in))
            phase("compact_blocks", bounce=b,
                  live=int((state_in[9] > 0).sum()), bit_identical=exact,
                  ms=f"{ck_ms:.4f}", plain_ms=f"{ck_plain_ms:.4f}",
                  device_ms=f"{kernel_ms(per, 'compact_kernel'):.4f}",
                  plain_device_ms=f"{pdev:.4f}")
            require(exact, "compact_blocks differs from its plain version")
            # the wavefront keeps its width: the live rows first, the
            # dead ones after them, as trace_wavefront runs it
            state_in, off_b, n_used = ck.pack_rows(*ck_k)
            require(int(n_used) > 0, f"no live lane before bounce {b}")
        fb_in[b] = state_in
        st_k, rad_k = bounce(fbk.fused_bounce, state_in, off_b, b)
        st_p, rad_p = bounce(fbk.fused_bounce_plain, state_in, off_b, b)
        torch.cuda.synchronize()
        n_diff = int(((st_k[9] > 0) != (st_p[9] > 0)).sum())
        d_state = float((st_k - st_p).abs().max())
        d_rad = float((rad_k - rad_p).abs().max())
        exact = torch.equal(st_k, st_p) and torch.equal(rad_k, rad_p)
        # intersect_state runs the same sphere loop: equal at every bounce
        ikw = dict(origin_zero=b == 0,
                   block_lists=lists if b == 0 else None,
                   sphere_bvh=None if b == 0 else hier)
        i_equal = all(torch.equal(g, w) for g, w in zip(
            sk.intersect_state(r.sph_table, state_in, **ikw),
            sk.intersect_state_plain(r.sph_table, state_in, **ikw)))
        fields = {"intersect_state_equal": i_equal}
        if b < 2:  # the plain version's times at bounces 0 and 1
            kms = time_ms(torch, lambda: bounce(fbk.fused_bounce, state_in,
                                                off_b, b))
            pms = time_ms(torch, lambda: bounce(fbk.fused_bounce_plain,
                                                state_in, off_b, b))
            fb_times[b] = (kms, pms)
            pdev, _, _, _ = device_times(
                torch, lambda: bounce(fbk.fused_bounce_plain, state_in,
                                      off_b, b))
            fields.update(ms=f"{kms:.4f}", plain_ms=f"{pms:.4f}",
                          plain_device_ms=f"{pdev:.4f}")
        _, per, _, _ = device_times(
            torch, lambda: bounce(fbk.fused_bounce, state_in, off_b, b))
        dev_ms = kernel_ms(per, "fused_bounce_kernel")
        if b > 0:
            fb_cull[b] = c = cull_work(torch, r, hier, state_in, n_sph)
            fields.update(
                leaves_per_warp_mean=f"{c['leaves_mean']:.2f}",
                leaves_per_warp_max=c["leaves_max"],
                nodes_per_warp_mean=f"{c['nodes_mean']:.2f}",
                nodes_per_warp_max=c["nodes_max"],
                pairs_tested=c["pairs"], pairs_brute=c["pairs_brute"],
                bound_ms_brute=f"{c['bound_brute']['bound_ms']:.4f}",
                bound_ms_culled=f"{c['bound_culled']['bound_ms']:.4f}")
        if b == 1:
            fields["before_cull_device_ms"] = BEFORE_CULL_MS["fused_bounce"]
        phase("fused_bounce", bounce=b, variant="listed" if b == 0 else "full",
              live_in=int((state_in[9] > 0).sum()),
              live_out=int((st_k[9] > 0).sum()), alive_diff=n_diff,
              max_abs_state=d_state, max_abs_rad=d_rad, equal=exact,
              device_ms=f"{dev_ms:.4f}", **fields)
        require(exact, f"bounce {b}: the kernel differs from its plain "
                f"version ({n_diff} alive flags, state {d_state}, "
                f"radiance {d_rad})")
        require(i_equal, f"bounce {b}: intersect_state differs from its "
                "plain version")
        fb_err = max(fb_err, d_state, d_rad)
        fb_dev[b] = dev_ms
        state_in = st_k

    two_k = two_kernel_kernels(torch, r, hier, fb_in, off, bg, n_sph)

    # --- 4. main path ----------------------------------------------------
    render = make_render_fn(cam, bg, WIDTH, HEIGHT, SPP, BOUNCES, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render(scene)  # first render: allocator and cuDNN warm-up
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counters = {"fused_bounce": fbk.fused_bounce,
                "compact_blocks": ck.compact_blocks, **no_path_kernels()}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    img_t, segments = render(scene)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    read_no_path("shirley", launches)
    img = img_t.cpu().numpy().astype(np.float64)
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
    wall_s = shirley_wall_s = statistics.median(walls)
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
          before_cull_fused_bounce_ms=BEFORE_CULL_MS["fused_bounce_render"],
          compact_ms=f"{kernel_ms(per, 'compact_kernel'):.3f}",
          device_ops=f"{n_ops:.0f}", kernels_seen=len(per))

    # --- 4b. the two-kernel render; 4c. the clustered kernel --------------
    two_k_launches = two_kernel_render(torch, np, make_render_fn, scene, cam,
                                       bg, dev, img_t, segments, render, smi)
    (cl_err, cl_ms, cl_plain_ms, cl_bound, cl_spheres_ms,
     cl_dev) = clustered_phase(torch, scene, r.sph_table, fb_in[1])

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

    ppm_kernels, ppm_launches, raster, cornell_lengths = ppm_phases(
        torch, np, dev, smi)

    mesh_kernels, mesh_launches, pt_launches, pt = mesh_phases(
        torch, np, dev, smi)

    md_launches, md_rank_launches = multi_device_phases(
        torch, np, dev, smi, (img_t, segments), pt, cornell_lengths)

    bvh4_kernel, bvh4_launches = bvh4_phases(torch, np, dev, smi, pt["rend"])

    seed_launches = seed_phases(torch, np, dev, smi, shirley_wall_s)

    # bounds of the PT kernels: bounce 1 (full) reads state (10 planes),
    # radiance (3), offsets and the hierarchy, writes state and radiance,
    # and runs the walk's node tests and pairs (cull_work; the brute
    # force's bound, every live ray against every valid sphere, beside it).
    # Compaction reads every lane's alive word and the 9 payload words and
    # offset of each live lane, and writes 10 state words and an offset per
    # lane and a count per block.
    fb_bound = fb_cull[1]["bound_culled"]
    n3, live3 = ck_in[1].numel(), int((ck_in[0][9] > 0).sum())
    ck_bound = bound(n3 * 4 + live3 * 40 + n3 * 44 + n3 // 1024 * 4, 0)
    # bounce 0 (listed): each live ray against its block's list
    n1 = fb_in[1].shape[1] * fb_in[1].shape[2]
    fb0_bound = bound(n1 * 4 * (10 + 3 + 1 + 10 + 3) + r.lists.numel() * 4
                      + (r.sph_table.numel() + r.pack_table.numel()) * 4,
                      listed_pairs(torch, r, fb_in[0]) * OPS["listed_sphere"])
    kernels = [
        entry("fused_bounce", "fused_bounce.cu",
              "pallas/fused_bounce_kernel.py:123", fb_err, *fb_times[1],
              **fb_bound, shape="shirley bounce 1 (full), 194560 lanes",
              device_ms=fb_dev[1],
              bound_ms_brute=fb_cull[1]["bound_brute"]["bound_ms"],
              device_ms_by_bounce=[round(fb_dev[b], 4)
                                   for b in range(BOUNCES)],
              ms_listed_bounce0=fb_times[0][0],
              plain_ms_listed_bounce0=fb_times[0][1],
              bound_ms_listed_bounce0=fb0_bound["bound_ms"]),
        entry("compact_blocks", "compact.cu", "pallas/compact_kernel.py:129",
              ck_err, ck_ms, ck_plain_ms, **ck_bound,
              shape="shirley bounce 3, 194560 lanes"),
    ]
    # every kernel of a render path runs on the one-process paths of
    # phases 4, 7, 11, 13, 15 and 16 it is on, and on phase 14's group of
    # one (in this process) and ranks (each rank's counts, read around its
    # renders, summed): launches is the sum of its one-process paths' runs,
    # each read on its own; launches_by_path holds every path's count,
    # phase 14's too. The path-traced render's numbers join the entries of
    # its six kernels
    paths = {"shirley": launches, "cornell": ppm_launches,
             "ganesha": mesh_launches, "ganesha_pt": pt_launches,
             **bvh4_launches, **seed_launches}
    multi = {"multi_device": md_launches,
             "multi_device_ranks": md_rank_launches}
    mesh_kernels.append(bvh4_kernel)
    # the mesh path tracer's bounce kernels on phase 13's pass 0: bounce 1
    # as ms, the other bounces beside it; plain_ms is the pair's plain
    # version (composite_hits after the query, scatter_bounce). They
    # replace no TPU kernel: the JAX trace's composite tier is XLA glue
    for name in ("mesh_bounce", "winner_t"):
        at = {b: pt[f"bounce_b{b}"][name] for b in PT_BOUNCE_CHECKS}
        k = entry(name, "mesh_bounce.cu", "", 0.0, at[1]["ms"],
                  pt["bounce_b1"]["plain_ms"], bound_ms=at[1]["bound_ms"],
                  bound_by="bytes", device_ms=at[1]["device_ms"],
                  device_ms_cold_l2=at[1]["device_ms_cold_l2"],
                  shape="ganesha_pt pass 0 bounce 1, 365568 lanes",
                  **{f"{key}_b{b}": v for b in PT_BOUNCE_CHECKS if b != 1
                     for key, v in at[b].items()},
                  **{f"plain_ms_b{b}": pt[f"bounce_b{b}"]["plain_ms"]
                     for b in PT_BOUNCE_CHECKS if b != 1})
        k["replaces"] = "pathtracer_tpu/integrator.py:212 (trace, XLA)"
        mesh_kernels.append(k)
    for k in kernels + ppm_kernels + mesh_kernels:
        by_path = {p: counts[k["name"]] for p, counts in paths.items()
                   if k["name"] in counts}
        k.update(launches=sum(by_path.values()), launches_by_path={
            **by_path, **{p: counts[k["name"]] for p, counts in
                          multi.items() if k["name"] in counts}})
    by_name = {k["name"]: k for k in ppm_kernels + mesh_kernels}
    for name, key in (("intersect_spheres", "spheres_b1"),
                      ("intersect_tris", "tris_b1")):
        by_name[name].update(ms_pt_bounce1=pt[key][0],
                             bound_ms_pt_bounce1=pt[key][1])
    by_name["intersect_tile_tris"].update(
        ms_pt=pt["tile_ms"], device_ms_pt=pt["tile_device_ms"],
        bound_ms_pt=pt["tile_bound_ms"])
    walk_pt = {f"{key}_pt_b{b}": pt[f"walk_b{b}"][key]
               for b in PT_WALK_BOUNCES
               for key in ("ms", "device_ms", "bound_ms", "bound_by",
                           "steps_max")}
    by_name["bvh8_walk"].update(
        **walk_pt, device_ms_pt_render=pt["walk_render_ms"],
        device_ms_pt_by_bounce=pt["walk_ms_by_bounce"])
    kernels += ppm_kernels + mesh_kernels
    # the two-kernel bounce: bounce 1 (full) as ms, bounce 0 (listed)
    # beside it; launches from the fuse_bounce=False render
    (i1, ib1, s1, sb1), (i0, ib0, s0, sb0) = two_k[1], two_k[0]
    kernels += [
        entry("intersect_state", "intersect_state.cu",
              "pallas/sphere_kernel.py:499", *i1, **ib1,
              shape="shirley bounce 1 (full), 194560 lanes",
              launches=two_k_launches["intersect_state"],
              path="make_render_fn(fuse_bounce=False)",
              ms_listed_bounce0=i0[1], plain_ms_listed_bounce0=i0[2],
              bound_ms_listed_bounce0=ib0["bound_ms"],
              bound_by_listed_bounce0=ib0["bound_by"],
              device_ms_cold_l2_listed_bounce0=ib0["device_ms_cold_l2"],
              replaces_listed="pathtracer_tpu/ops/pallas/sphere_kernel.py"
              ":487"),
        entry("shade_state", "shade.cu", "pallas/shade_kernel.py:407", *s1,
              **sb1, shape="shirley bounce 1, 194560 lanes",
              launches=two_k_launches["shade_state"],
              path="make_render_fn(fuse_bounce=False)",
              ms_bounce0=s0[1], plain_ms_bounce0=s0[2],
              bound_ms_bounce0=sb0["bound_ms"],
              device_ms_cold_l2_bounce0=sb0["device_ms_cold_l2"]),
        entry("intersect_clustered", "intersect_clustered.cu",
              "pallas/sphere_kernel.py:247", cl_err, cl_ms, cl_plain_ms,
              **cl_bound, shape="shirley bounce-1 rays, 194560 x 178 "
              "clusters", path=None, intersect_spheres_ms=cl_spheres_ms,
              device_ms=cl_dev),
        raster,
    ]
    # the kernels on no path: their counts as read around each of the six
    # main-path runs of phases 4-14 in this process and around phase 15's
    # and 16's; the BVH4 walk's as read around those six runs, beside
    # phase 15's
    require(len(NO_PATH_LAUNCHES) == 6,
            f"no-path counts read around {sorted(NO_PATH_LAUNCHES)}")
    for k in kernels[-2:]:
        by_path = {p: counts[k["name"]] for p, counts in
                   {**NO_PATH_LAUNCHES, **bvh4_launches,
                    **seed_launches}.items()}
        k.update(launches=sum(by_path.values()), launches_by_path=by_path)
    bvh4_kernel["launches_by_path"].update(
        {p: counts["bvh4_walk"] for p, counts in NO_PATH_LAUNCHES.items()})
    phase("no_path_launches", counts=json.dumps(NO_PATH_LAUNCHES))
    require(all(n == 0 for counts in NO_PATH_LAUNCHES.values()
                for n in counts.values()),
            f"a render launched a kernel of no path: {NO_PATH_LAUNCHES}")
    require(len(kernels) == 14, f"{len(kernels)} kernels in the JSON line")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--sweep-seg"]:
        sweep_seg()
    else:
        main()
