"""The photon mapper's spans and counters (pathtracer_tpu_torch.ppm,
utils.tracing), and that the path tracer's records stay as they were.

On the CPU, over a small closed mesh (an icosphere of 320 triangles) lit
by the ganesha spot lights at 32x32 and 2,048 photons: each PPMRenderer
.render() opens one ppm.render record with the PPM stages' spans; its
counters equal the render's own photon_map_lengths, iter_segments and
deposit rows, and the eye pass's lanes and hits; the number of host
reads (ppm.sync spans, counted by their intervals under a CPU profiler)
does not grow with the iterations; a path-traced mesh image's record
holds the pt.* spans and counters alone, and build_pt records one
build.scene span; and the sphere path tracer loads no photon mapper.

One test needs the card (marker `cuda`; this file imports no JAX, so it
runs there without the repository's conftest):

    python -m pytest --noconftest tests/test_torch_ppm_tracing.py

there the chunk gather's item-count read adds one ppm.sync an iteration,
and every device operation lies inside the ppm.render interval."""

import os
import subprocess
import sys

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pathtracer_tpu_torch.integrator import make_render_fn
from pathtracer_tpu_torch.models import ganesha
from pathtracer_tpu_torch.ppm import PPMRenderer, make_eye_pass
from pathtracer_tpu_torch.utils import tracing
from port_bench import meshes

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from tools.icosphere import icosphere  # noqa: E402

CPU = torch.device("cpu")
W = H = 32
PPM_SPANS = {"ppm.render", "ppm.photons", "ppm.chunks", "ppm.eye",
             "ppm.gather", "ppm.film", "ppm.sync"}


@pytest.fixture(autouse=True)
def store():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def ply(tmp_path_factory):
    verts, faces = icosphere(2, (328.0, 60.0, 150.0), 45.0)
    path = str(tmp_path_factory.mktemp("ppm_tracing") / "icosphere.ply")
    meshes.write_ply(path, verts, faces)
    return path


def _renderer(ply, device, iterations, w=W, h=H, photons=2048):
    scene, cam, lights, mesh = ganesha.build(ply, w / h, device)
    return PPMRenderer(scene, cam, lights, w, h, iterations=iterations,
                       photon_count=photons, verbose=False, mesh=mesh)


def _syncs(rec) -> int:
    return sum(name == "ppm.sync" for name, _, _, _ in rec.intervals)


def _check_counters(rend, rec, width, height):
    """The record's counters against the render's own lists, and the eye
    pass over the same tile table, iteration by iteration."""
    its = rend.iterations
    assert rec.counts["ppm.deposits"] == sum(
        int(n) for n in rend.photon_map_lengths)
    assert rec.counts["ppm.photon_segments"] == sum(
        int(s) for s, _ in rend.iter_segments)
    assert rec.counts["ppm.deposit_rows"] == its * rend.deposit_rows
    rows = -(-height // 32) * 32
    assert rec.counts["ppm.eye_lanes"] == its * (-(-width * rows // 1024)
                                                  * 1024)
    eye = make_eye_pass(rend.camera, width, height, rend.max_bounces,
                        rend.photon_count, rend.scene, 1, rend.mesh,
                        rend.tile_tensors(1))
    hits = sum(int(eye.walk(i * width * height)[3].sum())
               for i in range(its))
    assert 0 < rec.counts["ppm.eye_hits"] == hits


def test_each_render_opens_one_record(ply):
    rend = _renderer(ply, CPU, 1)
    rend.render()
    rend.render()
    recs = tracing.images()
    assert len(recs) == 2 and tracing.first_image() is recs[0]
    for rec in recs:
        assert PPM_SPANS <= set(rec.total_ns)
        assert tracing.ROOT not in rec.total_ns
        # the intersector's own spans, inside the photon and eye passes
        assert rec.total_ns["pt.walk"] > 0 and rec.total_ns["pt.tile"] > 0
    assert recs[0].seconds("ppm.render") > recs[0].seconds("ppm.photons")


def test_counters_equal_the_render(ply):
    rend = _renderer(ply, CPU, 3)
    rend.render()
    _check_counters(rend, tracing.images()[0], W, H)


def test_no_host_read_per_iteration(ply):
    """The diffuse check at the start and the closing read: two ppm.sync
    spans, at one iteration as at three (the CPU's plain gather reads no
    item count)."""
    counts = []
    for its in (1, 3):
        rend = _renderer(ply, CPU, its)
        with profile(activities=[ProfilerActivity.CPU]):
            rend.render()
        rec = tracing.images()[-1]
        counts.append(_syncs(rec))
        assert {(n, p) for n, p, _, _ in rec.intervals if n == "ppm.sync"} \
            == {("ppm.sync", "ppm.render")}
    assert counts == [2, 2]


def test_path_traced_records_are_unchanged(ply):
    """build_pt records one build.scene span of the set-up (it moved into
    build, which build_pt calls), with MeshBVH's build.mesh_bvh span
    inside it, and a path-traced mesh image's record
    holds the pt.* spans and counters it always held, with trace's count
    of its bounces (pt.mesh_bounces; on the CPU no pt.fused_bounces), no
    ppm.* one."""
    with profile(activities=[ProfilerActivity.CPU]):
        scene, cam, bg, mesh = ganesha.build_pt(ply, 1.0, CPU)
    assert [(n, p) for n, p, _, _ in tracing.setup().intervals] == [
        ("build.mesh_bvh", "build.scene"), ("build.scene", None)]
    render = make_render_fn(cam, bg, W, H, 2, 3, CPU, mesh=mesh)
    render(scene)
    render(scene)
    first, rec = tracing.images()
    assert set(first.total_ns) == set(rec.total_ns) | {"pt.renderer_init"}
    assert set(rec.total_ns) == {
        "pt.render", "pt.primary", "pt.bounce", "pt.intersect", "pt.tile",
        "pt.walk", "pt.scatter", "pt.film", "pt.sync"}
    assert set(rec.counts) == {"pt.lanes", "pt.live_lanes", "pt.passes",
                               "pt.mesh_bounces"}


def test_sphere_path_loads_no_photon_mapper():
    """A shirley render in a fresh process: neither the photon mapper nor
    the chunk gather is loaded."""
    code = (
        "import sys, torch\n"
        "from pathtracer_tpu_torch.integrator import make_render_fn\n"
        "from pathtracer_tpu_torch.models import shirley\n"
        "scene, cam, bg = shirley.build(2.0, torch.device('cpu'))\n"
        "make_render_fn(cam, bg, 32, 16, 1, 2, torch.device('cpu'))(scene)\n"
        "bad = [m for m in ('pathtracer_tpu_torch.ppm',\n"
        "    'pathtracer_tpu_torch.ops.cuda.gather_kernel') if m in "
        "sys.modules]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_render_records(ply, card):
    """A profiled 64x64 render of 2 iterations of 4,096 photons on the
    card: its counters equal the render's, its host reads are the two of
    the CPU plus the chunk gather's item count an iteration, and every
    device operation lies inside the ppm.render interval."""
    rend = _renderer(ply, card, 2, 64, 64, 4096)
    rend.render()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rend.render()
    rec = tracing.images()[-1]
    _check_counters(rend, rec, 64, 64)
    assert _syncs(rec) == 2 + rend.iterations
    (t0, t1), = [(s, e) for n, _, s, e in rec.intervals
                 if n == tracing.PPM_ROOT]
    ops = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA
           and not e.is_user_annotation()]
    assert len(ops) > 100
    outside = [o for o in ops if not t0 <= o[1] <= o[2] <= t1]
    assert not outside, (t0, t1, outside[:5])
