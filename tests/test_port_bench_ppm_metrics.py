"""The benchmark's readers of the ganesha-ppm cell's per-layer metrics, on
synthetic contexts: a profiling.Profile of named device operations and a
store of the program's records on a fake clock.

- ppm_driver.ops_per_image and .glue_ms_per_image read the device group's
  trace (as pt_driver's readers, which they load);
- ppm_driver.host_ms_per_image, .deposit_pct and .graph_iter_pct read the
  window's untraced images (from image warmup_images + trace_images +
  gap_images on);
- gather_roofline reads the chunk gather's kernels in the trace and the
  traced images' counters (from image warmup_images on): 36 bytes an eye
  hit and a deposit, over 3.35 TB/s, over the kernels' device time.
Each gives None without what it reads: no trace, no record (an older
program, or one without these spans), no card, no gather kernel."""

import sys
from types import SimpleNamespace

import pytest

from pathtracer_tpu_torch.utils import tracing
from port_bench import profiling, roofline, spans, spec

TRAFFIC = {"warmup_images": 2, "trace_images": 2, "gap_images": 1}
SPAN_READERS = ("ppm_driver.host_ms_per_image", "ppm_driver.deposit_pct",
                "ppm_driver.graph_iter_pct", "gather_roofline")
TRACE_READERS = ("ppm_driver.ops_per_image", "ppm_driver.glue_ms_per_image",
                 "gather_roofline")
NAMES = ("ppm_driver.ops_per_image", "ppm_driver.glue_ms_per_image",
         "ppm_driver.host_ms_per_image", "ppm_driver.deposit_pct",
         "ppm_driver.graph_iter_pct", "gather_roofline")
ITEMS, COMBINE = "gather_chunks_items_kernel", "gather_chunks_combine_kernel"


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


def _image(clock, ms, sync_ms, rows=1000, deposits=250, hits=400,
           iters=10, graphed=10):
    """One ppm.render record whose spans last the given ms, with the
    counters a render adds."""
    with tracing.span(tracing.PPM_ROOT):
        tracing.count("ppm.iters", iters)
        if graphed:
            tracing.count("ppm.graph_iters", graphed)
        with tracing.span("ppm.photons"):
            clock.t += int(2e6)
        tracing.count("ppm.deposit_rows", rows)
        with tracing.span("ppm.sync"):
            clock.t += int(sync_ms * 1e6)
        clock.t += int((ms - sync_ms - 2) * 1e6)
        tracing.count("ppm.deposits", deposits)
        tracing.count("ppm.photon_segments", 2 * deposits)
        tracing.count("ppm.eye_hits", hits)


def _profile(ops):
    busy = sum(s for _, s in ops)
    return profiling.Profile(window_s=2 * busy, busy_s=busy, ops=list(ops),
                             gaps=[])


def _ctx(profile=None, traced=2):
    return SimpleNamespace(traffic=TRAFFIC, profile=profile,
                           traced_images=traced)


def _read(name, ctx):
    return spec.load_metric(name).read(ctx)


OPS = [(ITEMS, 0.004), (COMBINE, 0.001), ("bvh8_walk_kernel", 0.010),
       ("intersect_tile_tris_items_kernel", 0.002),
       ("void at::native::vectorized_elementwise_kernel", 0.003),
       ("Memcpy DtoH (Device -> Pageable)", 0.001),
       ("void at::native::radixSortKVInPlace", 0.002)]


def test_trace_readers(clock):
    ctx = _ctx(_profile(OPS))
    assert _read("ppm_driver.ops_per_image", ctx) == pytest.approx(3.5)
    # the three operations that are none of the port's kernels
    assert _read("ppm_driver.glue_ms_per_image", ctx) == pytest.approx(3.0)


def test_span_readers_read_the_untraced_images(clock):
    # warm-up, traced and gap images first, with other numbers
    _image(clock, 9000, 50, rows=10, deposits=10)
    for _ in range(4):
        _image(clock, 400, 100, rows=1000, deposits=100)
    _image(clock, 300, 60, rows=1000, deposits=300)
    _image(clock, 500, 40, rows=3000, deposits=600)
    ctx = _ctx()
    assert _read("ppm_driver.host_ms_per_image", ctx) == pytest.approx(350.0)
    assert _read("ppm_driver.deposit_pct", ctx) == pytest.approx(22.5)


def test_graph_iter_pct_reads_the_untraced_images(clock):
    """Replayed iterations over all iterations of the untraced images: 100
    where each is a replay, 50 where half are, None where none is counted
    (a program whose renders count no iteration)."""
    for _ in range(5):  # warm-up (a capture's first iteration), traced, gap
        _image(clock, 100, 1, graphed=9)
    _image(clock, 100, 1)
    _image(clock, 100, 1)
    assert _read("ppm_driver.graph_iter_pct", _ctx()) == pytest.approx(100.0)
    _image(clock, 100, 1, iters=20, graphed=0)
    assert _read("ppm_driver.graph_iter_pct", _ctx()) == pytest.approx(50.0)
    tracing.reset()
    for _ in range(7):
        _image(clock, 100, 1, iters=0, graphed=0)
    assert _read("ppm_driver.graph_iter_pct", _ctx()) is None


def test_gather_roofline_reads_the_traced_images(clock):
    """The traced images are images 2 and 3 (after two warm-ups): 800 hits
    and 700 deposits; 1.5 s of device time on their two gather kernels."""
    _image(clock, 100, 1, hits=10_000, deposits=10_000)
    _image(clock, 100, 1, hits=10_000, deposits=10_000)
    _image(clock, 100, 1, hits=300, deposits=400)
    _image(clock, 100, 1, hits=500, deposits=300)
    for _ in range(3):
        _image(clock, 100, 1, hits=10_000, deposits=10_000)
    ops = [(ITEMS, 1.0), (COMBINE, 0.5), ("bvh8_walk_kernel", 9.0)]
    got = _read("gather_roofline", _ctx(_profile(ops)))
    n_bytes = 36 * (800 + 700)
    assert got == pytest.approx(100.0 * n_bytes / 3.35e12 / 1.5)
    assert got == pytest.approx(roofline.share_pct(n_bytes, 1.5))


@pytest.mark.parametrize("name", NAMES)
def test_no_record_and_no_trace_read_none(clock, name):
    assert _read(name, _ctx()) is None


@pytest.mark.parametrize("name", TRACE_READERS)
def test_no_traced_image_reads_none(clock, name):
    for _ in range(6):
        _image(clock, 100, 1)
    assert _read(name, _ctx(_profile(OPS), traced=0)) is None


def test_no_gather_kernel_reads_no_roofline(clock):
    for _ in range(6):
        _image(clock, 100, 1)
    ops = [(n, s) for n, s in OPS if n not in (ITEMS, COMBINE)]
    assert _read("gather_roofline", _ctx(_profile(ops))) is None
    assert _read("gather_roofline", _ctx(_profile(OPS))) is not None


@pytest.mark.parametrize("name", ("ppm_driver.deposit_pct",
                                  "gather_roofline"))
def test_path_traced_records_read_none(clock, name):
    """Records of pt.render images (another cell's, or an older program
    whose photon mapper opens none) carry no PPM span or counter."""
    for _ in range(8):
        with tracing.span(tracing.ROOT):
            tracing.count("pt.lanes", 10)
            clock.t += int(1e8)
    assert _read(name, _ctx(_profile(OPS))) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_program_without_tracing_reads_none(clock, monkeypatch, name):
    import pathtracer_tpu_torch.utils as utils
    for _ in range(8):
        _image(clock, 100, 1)
    assert _read(name, _ctx(_profile(OPS))) is not None
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "pathtracer_tpu_torch.utils.tracing",
                        None)
    assert _read(name, _ctx(_profile(OPS))) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_run_without_a_card_reads_none(clock, monkeypatch, name):
    for _ in range(8):
        _image(clock, 100, 1)
    monkeypatch.setattr(spans, "on_card", lambda: False)
    assert _read(name, _ctx(_profile(OPS))) is None
