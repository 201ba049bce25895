"""The path tracer's render spans and counters
(pathtracer_tpu_torch.utils.tracing).

On the CPU: the live lane counters sum to the segments a render returns
(the sphere path with a compaction, and with every lane dead before it;
the mesh path); spans' self time and nesting on a fake clock; no range
and no interval with no profiler running; and under a CPU profiler each
pt.* range lies inside its span's interval.

One test needs the card (marker `cuda`; this file imports no JAX, so it
runs there without the repository's conftest):

    python -m pytest --noconftest tests/test_torch_tracing.py

every device operation of a profiled image lies inside its pt.render
interval."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pathtracer_tpu_torch.integrator import LANES, make_render_fn
from pathtracer_tpu_torch.io import ply
from pathtracer_tpu_torch.models import ganesha, shirley
from pathtracer_tpu_torch.scene import LAMBERTIAN, SceneBuilder
from pathtracer_tpu_torch.utils import tracing

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from tools.make_test_mesh import uv_sphere  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def store():
    tracing.reset()
    yield
    tracing.reset()


class FakeClock:
    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


def _last_render(render, scene):
    img, segments = render(scene)
    return segments, tracing.images()[-1]


def test_sphere_live_lanes_sum_to_segments():
    """64x32, spp 2, 8 bounces: the compaction at bounce 3 packs the live
    lanes into the first rows, and every bounce runs over every lane."""
    scene, cam, bg = shirley.build(2.0, CPU)
    render = make_render_fn(cam, bg, 64, 32, 2, 8, CPU)
    segments, rec = _last_render(render, scene)
    lanes = 64 * 32  # whole tiles: 2 x 1 tiles of 1024 lanes
    assert rec.counts["pt.live_lanes"] == segments > 2 * 64 * 32
    assert rec.counts["pt.lanes"] == 2 * 8 * lanes
    assert rec.counts["pt.passes"] == 2
    assert rec.total_ns["pt.compact"] > 0 and rec.total_ns["pt.sync"] > 0
    assert rec.total_ns["pt.renderer_init"] > 0
    assert not rec.intervals
    # the renderer is kept for the same scene: no set-up the second time
    segments2, rec2 = _last_render(render, scene)
    assert segments2 == segments and "pt.renderer_init" not in rec2.total_ns


def test_sphere_pass_with_every_lane_dead_ends_at_the_compaction():
    """One small sphere behind the camera: every primary misses, so the
    pass's live lanes end at the compaction at bounce 3, which finds none;
    the bounces after it pass the dead lanes through. The live lanes are
    the primaries alone."""
    cam = shirley.make_camera(2.0)
    b = SceneBuilder()
    b.add_sphere((143.0, 22.0, 49.5), 1.0, LAMBERTIAN, color_a=(1, 1, 1))
    scene = b.build(camera=cam, device=CPU)
    segments, rec = _last_render(
        make_render_fn(cam, shirley.BACKGROUND, 64, 32, 2, 8, CPU), scene)
    assert segments == rec.counts["pt.live_lanes"] == 2 * 64 * 32
    assert rec.counts["pt.lanes"] == 2 * 8 * 64 * 32


def test_mesh_live_lanes_sum_to_segments(tmp_path):
    verts, faces = uv_sphere(12, 8, np.array([328.0, 60.0, 150.0]), 45.0)
    path = str(tmp_path / "tiny.ply")
    ply.write_mesh(path, verts, faces)
    scene, cam, bg, mesh = ganesha.build_pt(path, 1.0, CPU)
    assert tracing.setup().total_ns["build.scene"] > 0
    render = make_render_fn(cam, bg, 32, 32, 2, 3, CPU, mesh=mesh)
    segments, rec = _last_render(render, scene)
    assert rec.counts["pt.live_lanes"] == segments > 32 * 32
    assert rec.counts["pt.lanes"] == 2 * 3 * 1024
    for name in ("pt.renderer_init", "pt.primary", "pt.intersect",
                 "pt.tile", "pt.walk", "pt.scatter", "pt.film", "pt.sync"):
        assert rec.total_ns[name] > 0, name
    # the renderer is kept for the same scene: no set-up the second time
    segments2, rec2 = _last_render(render, scene)
    assert segments2 == segments and "pt.renderer_init" not in rec2.total_ns


def test_self_time_and_nesting(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(tracing, "_now", clock)
    with tracing.span("build.scene"):
        clock.t += 7
    tracing.count("pt.lanes", 5)  # outside a render: the set-up's
    for i in range(3):
        with tracing.span(tracing.ROOT):
            clock.t += 10
            with tracing.span("pt.bounce"):
                clock.t += 20
                with tracing.span("pt.sync"):
                    clock.t += 30 + i
                tracing.count("pt.lanes", 128)
            with tracing.span("pt.bounce"):
                clock.t += 40
    setup = tracing.setup()
    assert setup.total_ns == setup.self_ns == {"build.scene": 7}
    assert setup.counts == {"pt.lanes": 5}
    recs = tracing.images()
    assert len(recs) == 3 and tracing.first_image() is recs[0]
    r = recs[2]
    assert r.total_ns == {"pt.render": 102, "pt.bounce": 92, "pt.sync": 32}
    assert r.self_ns == {"pt.render": 10, "pt.bounce": 60, "pt.sync": 32}
    assert r.counts == {"pt.lanes": 128}
    assert r.seconds("pt.render") == pytest.approx(102e-9)
    assert [x.total_ns["pt.sync"] for x in tracing.images(1)] == [31, 32]


def test_records_are_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "KEEP", 4)
    tracing.reset()
    for i in range(10):
        with tracing.span(tracing.ROOT):
            tracing.count("pt.live_lanes", i)
    first = tracing.first_image()
    assert first.counts == {"pt.live_lanes": 0}
    assert [r.counts["pt.live_lanes"] for r in tracing.images()] == [6, 7,
                                                                    8, 9]
    # image indices count every image, dropped ones too
    assert [r.counts["pt.live_lanes"] for r in tracing.images(8)] == [8, 9]
    assert [r.counts["pt.live_lanes"] for r in tracing.images(2)] == [6, 7,
                                                                    8, 9]


def test_no_profiler_no_range_and_no_interval(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} with no profiler")

    monkeypatch.setattr(tracing, "_RecordFunctionFast", refuse)
    scene, cam, bg = shirley.build(2.0, CPU)
    render = make_render_fn(cam, bg, 32, 32, 1, 4, CPU)
    render(scene)
    rec = tracing.images()[-1]
    assert rec.total_ns["pt.bounce"] > 0
    assert not rec.intervals and not tracing.setup().intervals


def _annotations(prof):
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("pt.") and e.device_type() != DeviceType.CUDA:
            out.append((e.name(), e.start_ns(), e.end_ns()))
    return out


def test_annotations_lie_inside_their_intervals():
    """A CPU profiler over one render of 32x32, spp 1, 4 bounces (the
    compaction at bounce 3): every pt.* range the profiler recorded is
    one of the render's intervals, the n-th of a name inside the n-th.
    An earlier render of another scene object warms the process up; the
    profiled one builds its own renderer."""
    scene, cam, bg = shirley.build(2.0, CPU)
    render = make_render_fn(cam, bg, 32, 32, 1, 4, CPU)
    render(shirley.build(2.0, CPU)[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render(scene)
    rec = tracing.images()[-1]
    got = sorted(_annotations(prof))
    want = sorted((n, s, e) for n, _, s, e in rec.intervals)
    assert [g[0] for g in got] == [w[0] for w in want]
    assert {g[0] for g in got} >= {"pt.render", "pt.bounce", "pt.compact",
                                   "pt.sync", "pt.primary", "pt.film"}
    for (name, s, e), (_, s0, e0) in zip(got, want):
        assert s0 <= s <= e <= e0, (name, s0, s, e, e0)
    # the compaction at bounce 3 and the flush after the last bounce; the
    # image's closing read, its one read of the device
    assert {(n, p) for n, p, _, _ in rec.intervals} == {
        ("pt.render", None), ("pt.renderer_init", "pt.render"),
        ("pt.primary", "pt.render"), ("pt.bounce", "pt.render"),
        ("pt.compact", "pt.bounce"), ("pt.compact", "pt.render"),
        ("pt.film", "pt.render"), ("pt.sync", "pt.render")}
    assert sum(n == "pt.sync" for n, _, _, _ in rec.intervals) == 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_device_operations_lie_inside_the_render(card):
    """A profiled 256x128, spp 4, 8 bounces image on the card (its passes
    replayed as a CUDA graph): every device operation lies inside its
    pt.render interval, whose closing pt.sync waits for the last of them
    and is the image's one read of the device."""
    scene, cam, bg = shirley.build(2.0, card)
    render = make_render_fn(cam, bg, 256, 128, 4, 8, card)
    render(scene)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render(scene)
    rec = tracing.images()[-1]
    (t0, t1), = [(s, e) for n, _, s, e in rec.intervals if n == tracing.ROOT]
    ops = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA
           and not e.is_user_annotation()]
    assert len(ops) > 4 * 8
    outside = [o for o in ops if not t0 <= o[1] <= o[2] <= t1]
    assert not outside, (t0, t1, outside[:5])
    assert rec.counts["pt.lanes"] % LANES == 0
    assert rec.counts["pt.graph_passes"] == 4
    assert sum(n == "pt.sync" for n, *_ in rec.intervals) == 1
    assert sum("DtoH" in n for n, _, _ in ops) == 1, [
        n for n, _, _ in ops if "Memcpy" in n]
