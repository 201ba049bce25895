"""The benchmark's readers of the program's spans and counters, on a
synthetic store: each reads the window's untraced images (from image
warmup_images + trace_images + gap_images on), build.first_render_s the
first image, build.scene_span_s the set-up's build.scene spans, and each
gives None with no record and without a card (on
the CPU the kernels' plain versions run inside the PT driver's spans).
pt_driver.graph_pass_pct also gives None where no pass is counted (the
sphere path)."""

import sys
from types import SimpleNamespace

import pytest

from pathtracer_tpu_torch.utils import tracing
from port_bench import spans, spec

TRAFFIC = {"warmup_images": 2, "trace_images": 3, "gap_images": 1}
PER_IMAGE = ("pt_driver.host_ms_per_image", "pt_driver.sync_ms_per_image",
             "pt_driver.rebuild_ms_per_image", "pt_driver.live_lane_pct",
             "pt_driver.graph_pass_pct")
NAMES = PER_IMAGE + ("build.first_render_s", "build.scene_span_s")


class FakeClock:
    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    monkeypatch.setattr(spans, "on_card", lambda: True)
    tracing.reset()
    c = FakeClock()
    monkeypatch.setattr(tracing, "_now", c)
    yield c
    tracing.reset()


def _image(clock, ms, sync_ms, init_ms, bvh_ms, lanes, live, passes=0,
           graphed=0):
    """One image record whose spans last the given ms (1 ms = 1e6 ns)."""
    with tracing.span(tracing.ROOT):
        if passes:
            tracing.count("pt.passes", passes)
        if graphed:
            tracing.count("pt.graph_passes", graphed)
        with tracing.span("pt.renderer_init"):
            clock.t += int(init_ms * 1e6)
        with tracing.span("pt.sphere_bvh"):
            clock.t += int(bvh_ms * 1e6)
        with tracing.span("pt.bounce"):
            tracing.count("pt.lanes", lanes)
            tracing.count("pt.live_lanes", live)
            with tracing.span("pt.sync"):
                clock.t += int(sync_ms * 1e6)
        clock.t += int((ms - sync_ms - init_ms - bvh_ms) * 1e6)


def _build(clock, ms):
    """A set-up build.scene span of `ms` ms, outside any image."""
    with tracing.span("build.scene"):
        clock.t += int(ms * 1e6)


def _read(name):
    return spec.load_metric(name).read(SimpleNamespace(traffic=TRAFFIC))


def test_readers_read_the_untraced_images(clock):
    # six images before the window's untraced ones: the first is slow,
    # the traced ones are slower and have other counts
    _build(clock, 250)
    _image(clock, 9000, 50, 40, 30, 100, 100)
    _build(clock, 50)  # a second build, between images
    _image(clock, 200, 9, 20, 0, 100, 100)
    for _ in range(4):
        _image(clock, 400, 1, 30, 0, 100, 10)
    _image(clock, 100, 10, 20, 0, 1000, 500)
    _image(clock, 140, 30, 40, 0, 3000, 500)
    assert _read("pt_driver.host_ms_per_image") == pytest.approx(100.0)
    assert _read("pt_driver.sync_ms_per_image") == pytest.approx(20.0)
    assert _read("pt_driver.rebuild_ms_per_image") == pytest.approx(30.0)
    assert _read("pt_driver.live_lane_pct") == pytest.approx(25.0)
    assert _read("build.first_render_s") == pytest.approx(9.0)
    assert _read("build.scene_span_s") == pytest.approx(0.3)


def test_sphere_hierarchy_counts_as_rebuild(clock):
    for _ in range(6):
        _image(clock, 100, 1, 0, 0, 10, 10)
    _image(clock, 100, 1, 3, 5, 10, 10)
    assert _read("pt_driver.rebuild_ms_per_image") == pytest.approx(8.0)
    assert _read("pt_driver.host_ms_per_image") == pytest.approx(99.0)


@pytest.mark.parametrize("name", NAMES)
def test_no_record_reads_none(clock, name):
    assert _read(name) is None


def test_graph_pass_share_reads_the_untraced_images(clock):
    # the first image captures (one eager pass), the traced ones replay
    _image(clock, 900, 1, 0, 0, 10, 10, passes=8, graphed=7)
    for _ in range(5):
        _image(clock, 100, 1, 0, 0, 10, 10, passes=8, graphed=8)
    _image(clock, 100, 1, 0, 0, 10, 10, passes=8, graphed=8)
    _image(clock, 100, 1, 0, 0, 10, 10, passes=8, graphed=6)
    assert _read("pt_driver.graph_pass_pct") == pytest.approx(87.5)


def test_no_pass_counted_reads_no_graph_share(clock):
    for _ in range(8):  # the sphere path counts no pt.passes
        _image(clock, 100, 1, 0, 0, 10, 10)
    assert _read("pt_driver.live_lane_pct") == pytest.approx(100.0)
    assert _read("pt_driver.graph_pass_pct") is None


@pytest.mark.parametrize("name", PER_IMAGE)
def test_no_untraced_image_reads_none(clock, name):
    for _ in range(6):  # warm-up and traced images only
        _image(clock, 100, 1, 1, 0, 10, 10, passes=2, graphed=2)
    assert _read(name) is None
    assert _read("build.first_render_s") == pytest.approx(0.1)


def test_a_program_without_tracing_reads_none(clock, monkeypatch):
    """An older checkout of the program has no tracing module: the readers
    give None and raise nothing."""
    import pathtracer_tpu_torch.utils as utils
    _build(clock, 10)
    for _ in range(8):
        _image(clock, 100, 1, 1, 0, 10, 10)
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "pathtracer_tpu_torch.utils.tracing",
                        None)
    for name in NAMES:
        assert _read(name) is None


def test_a_run_without_a_card_reads_none(clock, monkeypatch):
    _build(clock, 10)
    for _ in range(8):
        _image(clock, 100, 1, 1, 0, 10, 10)
    assert _read("pt_driver.host_ms_per_image") == pytest.approx(99.0)
    monkeypatch.setattr(spans, "on_card", lambda: False)
    for name in NAMES:
        assert _read(name) is None
