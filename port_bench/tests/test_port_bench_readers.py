"""The window arithmetic, the profile's reading and the metrics' readers,
on synthetic inputs."""

from types import SimpleNamespace

import pytest

from port_bench import harness, profiling, roofline, spec


def test_image_s_is_the_whole_window_over_its_images():
    starts = [0.0, 1.0, 2.5, 3.0]
    ends = [1.0, 2.5, 3.0, 4.0]
    s = harness.window_stats(starts, ends)
    assert s["image_s"] == pytest.approx(1.0)
    # gaps between images count in the window too
    s = harness.window_stats([0.0, 2.0], [1.0, 3.0])
    assert s["image_s"] == pytest.approx(1.5)


def test_p95_is_over_all_images_by_nearest_rank():
    def p95(slow):
        times = [1.0] * slow + [0.1] * (200 - slow)
        starts = [float(i) for i in range(200)]
        return harness.window_stats(
            starts, [s + t for s, t in zip(starts, times)])["image_p95_s"]
    # rank ceil(0.95 * 200) = 190: ten slow images stay above it
    assert p95(10) == pytest.approx(0.1)
    assert p95(11) == pytest.approx(1.0)


def test_a_stall_inside_the_window_moves_both():
    starts = [0.1 * i for i in range(100)]
    ends = [s + 0.1 for s in starts]
    base = harness.window_stats(starts, ends)
    stalled_ends = list(ends)
    for i in range(50, 100):  # image 50 stalls 2 s, the rest shift
        stalled_ends[i] += 2.0
    stalled_starts = [s if i <= 50 else s + 2.0 for i, s in
                      enumerate(starts)]
    for i in range(94, 100):
        stalled_ends[i] += 1.0  # and the last six images are slow
    st = harness.window_stats(stalled_starts, stalled_ends)
    assert st["image_s"] > base["image_s"] * 1.2
    assert st["image_p95_s"] > base["image_p95_s"] * 5


def _synthetic():
    # window 0..100 us; device busy 10-30, 25-40, 70-80 (us)
    device = [("fused_bounce_kernel<1>", 10, 30), ("aten_copy", 25, 40),
              ("bvh8_walk_kernel", 70, 80), ("late", 120, 130)]
    host = [(profiling.WINDOW, 0, 100), ("port_bench.render", 1, 60),
            ("aten::mul", 35, 50), ("cudaLaunchKernel", 40, 43),
            ("port_bench.to_host", 60, 99), ("aten::copy_", 61, 98)]
    return profiling.summarize(device, host, (0, 100))


def test_idle_share_from_a_synthetic_profile():
    p = _synthetic()
    assert p.window_s == pytest.approx(100e-6)
    assert p.busy_s == pytest.approx(40e-6)  # 10-40 and 70-80
    # two traced images, busy 20 us each, against untraced images of 50 us:
    # the traced window's own length (its profiler's cost) plays no part
    ctx = SimpleNamespace(profile=p, traced_images=2, untraced_image_s=50e-6)
    idle = spec.load_metric("device.idle_pct")
    assert idle.read(ctx) == pytest.approx(60.0)
    p.window_s = 1.0
    assert idle.read(ctx) == pytest.approx(60.0)
    ctx.untraced_image_s = None  # no untraced image: nothing to read
    assert idle.read(ctx) is None
    gaps = dict((n, s) for n, s in p.breakdown()["idle_gaps"])
    assert gaps["between_spans"] == pytest.approx(10e-6)
    assert gaps["render/aten::mul"] == pytest.approx(30e-6)
    assert gaps["to_host/aten::copy_"] == pytest.approx(20e-6)
    assert p.device(("bvh8_walk_kernel",)) == (pytest.approx(10e-6), 1)
    assert p.outside(("fused_bounce_kernel", "bvh8_walk_kernel")) == (
        pytest.approx(15e-6), 1)


def _ctx(profile, **kw):
    traffic = dict(width=600, height=300, spp=32, max_bounces=8)
    traffic.update(kw.pop("traffic", {}))
    return SimpleNamespace(profile=profile, traced_images=kw.get("images", 2),
                           traced_segments=kw.get("segments", 0),
                           untraced_image_s=kw.get("image_s", 0.1),
                           traffic=traffic, sizes=kw.get("sizes", {}),
                           build_s=0.5)


def test_bounce_bound_from_segments_and_spheres():
    mod = spec.load_metric("bounce_roofline")
    p = profiling.Profile(1.0, 0.5, [("fused_bounce_kernel<1>", 0.01),
                                     ("other", 0.3)], [])
    ctx = _ctx(p, images=2, segments=28_000_000, sizes={"spheres": 530})
    n_bytes = (28_000_000 * mod.SEGMENT_BYTES
               + 2 * 32 * 8 * 530 * mod.SPHERE_BYTES)
    assert mod.SEGMENT_BYTES == 88 and mod.SPHERE_BYTES == 36
    assert mod.read(ctx) == pytest.approx(
        100 * n_bytes / roofline.HBM_BYTES_PER_S / 0.01)
    ctx.profile = profiling.Profile(1.0, 0.5, [("other", 0.3)], [])
    assert mod.read(ctx) is None  # nothing to read: no share of 0


def test_walk_bound_from_rays_past_the_primaries_and_triangles():
    mod = spec.load_metric("walk_roofline")
    p = profiling.Profile(1.0, 0.5, [("bvh8_walk_kernel", 0.02)], [])
    prim = 600 * 600 * 8
    ctx = _ctx(p, images=1, segments=prim + 5_000_000,
               sizes={"mesh_triangles": 449_352},
               traffic=dict(width=600, height=600, spp=8, max_bounces=8))
    n_bytes = 5_000_000 * 44 + 8 * 7 * 449_352 * 36
    assert mod.read(ctx) == pytest.approx(
        100 * n_bytes / roofline.HBM_BYTES_PER_S / 0.02)


def test_driver_and_build_readers():
    p = profiling.Profile(1.0, 0.5, [("fused_bounce_kernel", 0.01),
                                     ("aten_add", 0.002),
                                     ("Memcpy DtoH", 0.001)], [])
    ctx = _ctx(p, images=2)
    ops = spec.load_metric("pt_driver.ops_per_image").read(ctx)
    glue = spec.load_metric("pt_driver.glue_ms_per_image").read(ctx)
    assert ops == pytest.approx(1.5) and glue == pytest.approx(1.5)
    assert spec.load_metric("build.scene_s").read(ctx) == 0.5
    for name in ("pt_driver.ops_per_image", "device.idle_pct",
                 "bounce_roofline"):
        assert spec.load_metric(name).read(_ctx(None)) is None
