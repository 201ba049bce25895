"""The benchmark's readers of the cornell-ppm cell's two new per-layer
metrics, on synthetic contexts (test_port_bench_ppm_metrics.py's fake
clock and profiles):

- ppm_driver.walk_live_pct reads the window's untraced images (from image
  warmup_images + trace_images + gap_images on): 100 x ppm.walk_live over
  ppm.walk_lanes;
- pools_roofline reads the pool kernels in the trace and the traced
  images' counters (from image warmup_images on): 32 bytes a photon
  segment and a live walk lane, and the pools' primitives once a photon
  bounce and a walk bounce, over 3.35 TB/s, over the kernels' device time.
Each gives None without what it reads: no record, no trace, no card, a
program without the walk counters (the parent of the counters), no pool
kernel."""

from types import SimpleNamespace

import pytest

from pathtracer_tpu_torch.utils import tracing
from port_bench import roofline, spans, spec
from test_port_bench_ppm_metrics import _profile, clock  # noqa: F401

TRAFFIC = {"warmup_images": 2, "trace_images": 2, "gap_images": 1,
           "max_bounces": 4}
SIZES = {"spheres": 3, "triangles": 18}
NAMES = ("ppm_driver.walk_live_pct", "pools_roofline")
SPHERES, TRIS = "intersect_spheres_kernel", "intersect_tris_kernel"
OPS = [(SPHERES, 0.002), (TRIS, 0.003), ("gather_chunks_items_kernel", 0.004),
       ("void at::native::vectorized_elementwise_kernel", 0.003)]


def _image(clock, live=300, lanes=1000, eye_lanes=250, segments=500,
           iters=10, walk=True):
    """One ppm.render record with the counters a render adds; walk=False
    leaves out the walk counters, as a program without them does."""
    with tracing.span(tracing.PPM_ROOT):
        tracing.count("ppm.iters", iters)
        tracing.count("ppm.eye_lanes", eye_lanes)
        clock.t += int(1e8)
        tracing.count("ppm.photon_segments", segments)
        if walk:
            tracing.count("ppm.walk_lanes", lanes)
            tracing.count("ppm.walk_live", live)


def _ctx(profile=None, traced=2):
    return SimpleNamespace(traffic=TRAFFIC, profile=profile,
                           traced_images=traced, sizes=SIZES)


def _read(name, ctx):
    return spec.load_metric(name).read(ctx)


def test_walk_live_pct_reads_the_untraced_images(clock):
    for _ in range(5):  # warm-up, traced and gap images, other numbers
        _image(clock, live=1, lanes=1000)
    _image(clock, live=300, lanes=1000)
    _image(clock, live=500, lanes=3000)
    assert _read("ppm_driver.walk_live_pct", _ctx()) == pytest.approx(20.0)


def test_pools_roofline_reads_the_traced_images(clock):
    """The traced images are images 2 and 3 (after two warm-ups): 10
    iterations each of 4 photon bounces and, with walk lanes 4 x the eye
    lanes, 4 walk bounces; 5 ms of device time on the two pool kernels."""
    _image(clock, live=10 ** 6, segments=10 ** 6)
    _image(clock, live=10 ** 6, segments=10 ** 6)
    _image(clock, live=300, lanes=1000, eye_lanes=250, segments=500)
    _image(clock, live=700, lanes=1000, eye_lanes=250, segments=100)
    for _ in range(3):
        _image(clock, live=10 ** 6, segments=10 ** 6)
    got = _read("pools_roofline", _ctx(_profile(OPS)))
    bounces = 2 * 10 * (4 + 4)
    n_bytes = 32 * (600 + 1000) + bounces * (3 * 16 + 18 * 36)
    assert got == pytest.approx(roofline.share_pct(n_bytes, 0.005))
    assert got == pytest.approx(100.0 * n_bytes / 3.35e12 / 0.005)


@pytest.mark.parametrize("name", NAMES)
def test_no_record_and_no_trace_read_none(clock, name):
    assert _read(name, _ctx()) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_the_walk_counters_reads_none(clock, name):
    for _ in range(8):
        _image(clock, walk=False)
    assert _read(name, _ctx(_profile(OPS))) is None
    tracing.reset()
    for _ in range(8):
        _image(clock)
    assert _read(name, _ctx(_profile(OPS))) is not None


def test_no_pool_kernel_reads_no_roofline(clock):
    for _ in range(6):
        _image(clock)
    ops = [(n, s) for n, s in OPS if n not in (SPHERES, TRIS)]
    assert _read("pools_roofline", _ctx(_profile(ops))) is None
    assert _read("pools_roofline", _ctx(_profile(OPS), traced=0)) is None
    assert _read("pools_roofline", _ctx(_profile(OPS))) is not None


@pytest.mark.parametrize("name", NAMES)
def test_a_run_without_a_card_reads_none(clock, monkeypatch, name):
    for _ in range(8):
        _image(clock)
    monkeypatch.setattr(spans, "on_card", lambda: False)
    assert _read(name, _ctx(_profile(OPS))) is None
