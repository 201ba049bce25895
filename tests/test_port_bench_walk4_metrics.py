"""The benchmark's readers of the ganesha-pt-1.8m cell's three new
per-layer metrics, on synthetic contexts (test_port_bench_ppm_metrics.py's
fake clock and profiles):

- walk4_roofline reads the BVH4 walk kernel in the trace and the traced
  images' pt.walk_rays (from image warmup_images on): 44 bytes a walked
  ray and the mesh's triangles at 36 bytes once a walk, over 3.35 TB/s,
  over the kernel's device time;
- pt_driver.walk_loads_per_ray reads the window's untraced images (from
  image warmup_images + trace_images + gap_images on): pt.walk_loads over
  pt.walk_rays;
- build.mesh_bvh_s reads the set-up's build.mesh_bvh spans.
Each gives None without what it reads: no record, no trace, no card, a
program without the counters or the span (one older than them), no
BVH4 walk kernel."""

from types import SimpleNamespace

import pytest

from pathtracer_tpu_torch.utils import tracing
from port_bench import roofline, spans, spec
from test_port_bench_ppm_metrics import _profile, clock  # noqa: F401

TRAFFIC = {"warmup_images": 2, "trace_images": 2, "gap_images": 1,
           "spp": 8, "max_bounces": 8}
SIZES = {"spheres": 0, "mesh_triangles": 1_797_408}
NAMES = ("walk4_roofline", "pt_driver.walk_loads_per_ray",
         "build.mesh_bvh_s")
WALK4, WALK8 = "bvh4_walk_kernel", "bvh8_walk_kernel"
OPS = [(WALK4, 0.02), ("intersect_tile_tris_items_kernel", 0.01),
       ("mesh_bounce_kernel", 0.003),
       ("void at::native::vectorized_elementwise_kernel", 0.002)]


def _image(clock, rays=1000, loads=16000, counters=True):
    """One pt.render record with the counters a render on a BVH4 mesh
    adds; counters=False leaves out the walk's, as a program without them
    (or a BVH8 mesh) does."""
    with tracing.span(tracing.ROOT):
        tracing.count("pt.passes", 8)
        clock.t += int(3e7)
        if counters:
            tracing.count("pt.walk_rays", rays)
            tracing.count("pt.walk_loads", loads)


def _setup(clock, seconds=4.0):
    with tracing.span("build.scene"):
        with tracing.span("build.mesh_bvh"):
            clock.t += int(seconds * 1e9)
        clock.t += int(1e9)


def _ctx(profile=None, traced=2):
    return SimpleNamespace(traffic=TRAFFIC, profile=profile,
                           traced_images=traced, sizes=SIZES)


def _read(name, ctx):
    return spec.load_metric(name).read(ctx)


def test_walk4_roofline_reads_the_traced_images(clock):
    """The traced images are images 2 and 3 (after two warm-ups); 20 ms of
    device time on the BVH4 walk, none counted from other kernels."""
    _image(clock, rays=10 ** 9)
    _image(clock, rays=10 ** 9)
    _image(clock, rays=2_000_000)
    _image(clock, rays=3_000_000)
    for _ in range(3):
        _image(clock, rays=10 ** 9)
    got = _read("walk4_roofline", _ctx(_profile(OPS + [(WALK8, 1.0)])))
    walks = 2 * 8 * 7
    n_bytes = 44 * 5_000_000 + walks * 1_797_408 * 36
    assert got == pytest.approx(roofline.share_pct(n_bytes, 0.02))
    assert got == pytest.approx(100.0 * n_bytes / 3.35e12 / 0.02)


def test_walk_loads_per_ray_reads_the_untraced_images(clock):
    for _ in range(5):  # warm-up, traced and gap images, other numbers
        _image(clock, rays=1, loads=1000)
    _image(clock, rays=1000, loads=15000)
    _image(clock, rays=3000, loads=49000)
    assert _read("pt_driver.walk_loads_per_ray", _ctx()) == \
        pytest.approx(16.0)


def test_mesh_bvh_s_reads_the_setup_span(clock):
    _setup(clock, 4.0)
    _image(clock)
    assert _read("build.mesh_bvh_s", _ctx()) == pytest.approx(4.0)
    tracing.reset()
    with tracing.span("build.scene"):
        clock.t += int(1e9)
    assert _read("build.mesh_bvh_s", _ctx()) is None


@pytest.mark.parametrize("name", NAMES)
def test_no_record_and_no_trace_read_none(clock, name):
    assert _read(name, _ctx()) is None


@pytest.mark.parametrize("name", NAMES[:2])
def test_a_program_without_the_walk_counters_reads_none(clock, name):
    for _ in range(8):
        _image(clock, counters=False)
    assert _read(name, _ctx(_profile(OPS))) is None
    tracing.reset()
    for _ in range(8):
        _image(clock)
    assert _read(name, _ctx(_profile(OPS))) is not None


def test_walk_rays_without_loads_read_no_loads_per_ray(clock):
    """The plain walk off the card counts rays and no loads."""
    for _ in range(8):
        with tracing.span(tracing.ROOT):
            tracing.count("pt.walk_rays", 1000)
    assert _read("pt_driver.walk_loads_per_ray", _ctx()) is None


def test_no_bvh4_kernel_reads_no_roofline(clock):
    for _ in range(6):
        _image(clock)
    ops = [(n, s) for n, s in OPS if n != WALK4] + [(WALK8, 0.02)]
    assert _read("walk4_roofline", _ctx(_profile(ops))) is None
    assert _read("walk4_roofline", _ctx(_profile(OPS), traced=0)) is None
    assert _read("walk4_roofline", _ctx(_profile(OPS))) is not None


@pytest.mark.parametrize("name", NAMES)
def test_a_run_without_a_card_reads_none(clock, monkeypatch, name):
    _setup(clock)
    for _ in range(8):
        _image(clock)
    assert _read(name, _ctx(_profile(OPS))) is not None
    monkeypatch.setattr(spans, "on_card", lambda: False)
    assert _read(name, _ctx(_profile(OPS))) is None
