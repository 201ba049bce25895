"""The sphere path tracer's pass at its full width
(integrator.trace_wavefront), on the CPU.

After a compaction every bounce runs over all the rows: the live lanes
are packed into the first rows and the dead ones after them pass through
the bounce. Nothing goes to the host inside a pass, so that a card can
replay the pass as one CUDA graph; every bounce counts all the lanes in
pt.lanes.

  - The pass is held bit for bit (radiance and segments) to the rule it
    replaced, which lives here as its plain version, `_trimmed_trace`:
    each compaction read its row count on the host, cut the wavefront to
    the rows up to the last live one in whole 1024-lane blocks, and ended
    the pass where no row was left. Cases: 8 bounces (one compaction, at
    3), 16 (at 2 and 4), a band that overhangs the image (dead blocks from
    bounce 0 on), and a pass whose every lane dies before the compaction,
    at 8 and 16 bounces.
  - The bounce passes a dead lane through, its state and radiance as they
    were, which the rows past the live ones rely on, and bounces the live
    lanes as it would without the dead ones: 0 to 4 of a wavefront's four
    blocks dead at its end, or one in its middle."""

import pytest
import torch

from pathtracer_tpu_torch import integrator
from pathtracer_tpu_torch.integrator import LANES, Renderer
from pathtracer_tpu_torch.models import shirley
from pathtracer_tpu_torch.ops.cuda import compact_kernel as ck
from pathtracer_tpu_torch.ops.cuda import fused_bounce_kernel as fbk
from pathtracer_tpu_torch.scene import LAMBERTIAN, SceneBuilder
from pathtracer_tpu_torch.utils import tracing

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def store():
    tracing.reset()
    yield
    tracing.reset()


def _trimmed_trace(sph_table, pack_table, state, off, sampler, max_bounces,
                   background, *, origin_zero, block_lists0=None):
    """The wavefront as each compaction used to cut it: the row count read
    on the host, the rows kept rounded up to whole 1024-lane blocks, the
    pass ended where none is kept; every bounce counts its rows' lanes in
    pt.lanes."""
    bg_mode, bg = background
    compact_at = {b for b in integrator._default_compact_at(max_bounces)
                  if 0 < b < max_bounces}
    rows = state.shape[1]
    rad = torch.zeros(3, rows, LANES)
    flush = torch.zeros(3, rows * LANES)
    segments = torch.zeros((), dtype=torch.int64)
    chain = []
    for bounce in range(max_bounces):
        if bounce in compact_at:
            flush += integrator._to_orig(rad, chain)
            alive_pre = state[9] > 0.0
            st_c, off_c, k = ck.compact_blocks(state, off)
            state, off, n_used = ck.pack_rows(st_c, off_c, k)
            chain.append((alive_pre.reshape(-1), ck.dest_map(alive_pre, k)))
            keep = -(-int(n_used) // 8) * 8
            if keep == 0:
                return flush.reshape(3, rows, LANES), segments
            state = state[:, :keep].contiguous()
            off = off[:keep].contiguous()
            rad = torch.zeros(3, keep, LANES)
        tracing.count("pt.lanes", state.shape[1] * LANES)
        segments += (state[9] > 0.0).sum()
        state, rad = fbk.fused_bounce_plain(
            sph_table, state, pack_table, off,
            sampler.limbs(2 + 2 * bounce, 3 + 2 * bounce), bg, rad,
            bg_mode=bg_mode, origin_zero=origin_zero and bounce == 0,
            block_lists=block_lists0 if bounce == 0 else None)
    flush += integrator._to_orig(rad, chain)
    return flush.reshape(3, rows, LANES), segments


def _renderer(case: str, bounces: int) -> Renderer:
    """64x32 shirley (two tiles), over a band of two tile rows for "band"
    (the second past the image), or a scene of one small sphere behind
    the camera for "dead" (every primary misses)."""
    if case.startswith("dead"):
        cam = shirley.make_camera(2.0)
        b = SceneBuilder()
        b.add_sphere((143.0, 22.0, 49.5), 1.0, LAMBERTIAN, color_a=(1, 1, 1))
        return Renderer(b.build(camera=cam, device=CPU), cam,
                        shirley.BACKGROUND, 64, 32, 4, bounces, CPU)
    scene, cam, bg = shirley.build(2.0, CPU)
    band = {"band_tile_rows": 2} if case.startswith("band") else {}
    return Renderer(scene, cam, bg, 64, 32, 4, bounces, CPU, **band)


@pytest.mark.parametrize("case", ["b8", "b16", "band_b8", "dead_b8",
                                  "dead_b16"])
def test_full_width_pass_equals_the_trimmed_pass(case):
    bounces = 16 if case.endswith("16") else 8
    r = _renderer(case, bounces)
    first = min(integrator._default_compact_at(bounces))
    for pass_idx in (0, 3):
        state, off = r.initial_wavefront(pass_idx)
        lanes = state.shape[1] * LANES
        args = (r.sph_table, r.pack_table, state, off, r.sampler, bounces,
                r.background)
        kw = dict(origin_zero=True, block_lists0=(r.lists, r.counts))
        tracing.reset()
        want_rad, want_segs = _trimmed_trace(*args, **kw)
        trimmed_lanes = tracing.setup().counts["pt.lanes"]
        tracing.reset()
        rad, segs = integrator.trace_wavefront(*args, **kw)
        assert torch.equal(rad, want_rad)
        assert int(segs) == int(want_segs) > 0
        assert tracing.setup().counts["pt.lanes"] == bounces * lanes
        if case.startswith("dead"):  # the old pass ended at the compaction
            assert trimmed_lanes == first * lanes
            assert int(segs) == 64 * 32
        else:  # and kept fewer rows after it
            assert first * lanes < trimmed_lanes < bounces * lanes


@pytest.mark.parametrize("dead", ["none", "last", "last3", "all",
                                  "middle"])
def test_plain_bounce_passes_the_dead_blocks_at_the_end_through(dead):
    """A bounce-1 wavefront of 64x64 (four blocks) with blocks killed
    (alive 0, the rest of their state and their radiance kept): on the
    killed blocks fused_bounce_plain returns its input, on the others what
    it returns for the wavefront with no block killed."""
    scene, cam, bg = shirley.build(1.0, CPU)
    r = Renderer(scene, cam, bg, 64, 64, 1, 8, CPU)
    bg_mode, colors = r.background
    state, off = r.initial_wavefront(0)
    rad = torch.zeros(3, state.shape[1], LANES)
    state, rad = fbk.fused_bounce_plain(
        r.sph_table, state, r.pack_table, off, r.sampler.limbs(2, 3), colors,
        rad, bg_mode=bg_mode, origin_zero=True,
        block_lists=(r.lists, r.counts))
    assert bool((rad != 0).any())
    killed = {"none": [], "last": [3], "last3": [1, 2, 3],
              "all": [0, 1, 2, 3], "middle": [1]}[dead]
    dead_rows = torch.zeros(state.shape[1], dtype=torch.bool)
    for blk in killed:
        dead_rows[8 * blk:8 * blk + 8] = True
    killed_state = state.clone()
    killed_state[9, dead_rows] = 0.0
    assert bool((killed_state[9] > 0).any()) == (dead != "all")
    limbs = r.sampler.limbs(4, 5)

    def bounce(st):
        return fbk.fused_bounce_plain(r.sph_table, st, r.pack_table, off,
                                      limbs, colors, rad, bg_mode=bg_mode,
                                      origin_zero=False)

    st, rd = bounce(killed_state)
    want_st, want_rd = bounce(state)
    assert torch.equal(st[:, dead_rows], killed_state[:, dead_rows])
    assert torch.equal(rd[:, dead_rows], rad[:, dead_rows])
    assert torch.equal(st[:, ~dead_rows], want_st[:, ~dead_rows])
    assert torch.equal(rd[:, ~dead_rows], want_rd[:, ~dead_rows])
