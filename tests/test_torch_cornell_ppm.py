"""The cornell-box deployment of the benchmark (configs/cornell.json, entry
ppm_pools) on the CPU: the port's PPMRenderer against the plain float64
reference with the specular walk (port_bench/reference/ppm_specular.py),
the configuration against the port's own scene, and the eye walk's
counters (ppm.walk_lanes, ppm.walk_live).

Tolerances (the port computes in float32, the reference in float64; the
program's readings at 40x40 to 64x64, 2-3 iterations of 2,048-5,000
photons: image 3.6e-6-6.2e-6, segments equal):
- image RMSE over the reference's RMS <= 5e-5: at these sizes the radius
  is ~0.4 of the unit box, so a pixel gathers hundreds of deposits, and
  float32 moves a deposit by ~1e-7 of the box; a photon path parts from
  the reference's only where a ray grazes an edge of the light box or a
  sample lies within rounding of a Schlick reflectance or an albedo;
- photon segments within 5e-4 of the reference's (~6 of 12,283): the
  same parted paths.
The reference in bfloat16 (its control) reads 0.39 and 0.11."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator import Intersector
from pathtracer_tpu_torch.models import cornell, ganesha
from pathtracer_tpu_torch.ppm import PPMRenderer, make_eye_pass
from pathtracer_tpu_torch.scene import TRI_A, TRI_E1, TRI_E2, TRI_TEX
from pathtracer_tpu_torch.utils import tracing
from port_bench import compare, meshes, readings, spec
from port_bench.entries import ppm_pools
from port_bench.reference import ppm_specular, scenes
from test_torch_ppm_reference import _fields, _Reads

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from tools.icosphere import icosphere  # noqa: E402

CPU = torch.device("cpu")
W = H = 48
PARAMS = dict(iterations=2, photon_count=2048, alpha=2.0 / 3.0,
              max_bounces=4)
IMAGE_RMSE = 5e-5
SEGMENTS_GAP = 5e-4


@pytest.fixture(scope="module")
def config():
    with open(os.path.join(ROOT, "port_bench", "configs",
                           "cornell.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port():
    """The renderer after one render, and that render's image, segments
    and record."""
    tracing.reset()
    scene, cam, lights = cornell.build(W / H, CPU)
    rend = PPMRenderer(scene, cam, lights, W, H, verbose=False, **PARAMS)
    img = (rend.render() / PARAMS["iterations"]).numpy()
    segments = int(sum(int(s) for s, _ in rend.iter_segments))
    rec = tracing.images()[-1]
    tracing.reset()
    return rend, img, segments, rec


def _reference(config, dtype):
    sc, cam, lights = ppm_specular.scene(config, W / H)
    return ppm_specular.render(sc, cam, lights, W, H, device=CPU,
                               dtype=dtype, **PARAMS)


@pytest.fixture(scope="module")
def reference(config):
    return _reference(config, torch.float64)


def test_port_matches_the_reference(port, reference):
    got = compare.image_numbers(port[1], port[2], *reference)
    assert float(np.sqrt(np.mean(reference[0] ** 2))) > 0.05
    assert reference[1] > 2 * 2048  # emission and bounces past it
    assert got["nonfinite_px"] == 0
    assert got["image_rmse"] <= IMAGE_RMSE, got
    assert got["segments_gap"] <= SEGMENTS_GAP, got


def test_bfloat16_reference_is_not_correct(config, reference):
    """The control: the same reference in bfloat16 (the unit box resolves
    to 1/256 there, against a radius of ~0.4) fails both."""
    got = compare.image_numbers(*_reference(config, torch.bfloat16),
                                *reference)
    assert got["image_rmse"] > IMAGE_RMSE, got
    assert got["segments_gap"] > SEGMENTS_GAP, got


def test_every_configuration_field_is_read(monkeypatch):
    """cornell.json: each field that is not documentation (source,
    command, reduced, assumed) is read by a run's inputs, the reference's
    scene and lights, or the control's precision."""
    cell = spec.cell("cornell-ppm")
    seen = set()
    config = _Reads(cell["config_spec"], seen)
    monkeypatch.setattr(ppm_specular, "render", lambda *a, **k: None)
    traffic = dict(cell["traffic_spec"], width=8, height=8)
    ppm_pools.Inputs(config, traffic, 12345).reference("cpu")
    readings.CONTROL[config["precision"]]
    documents = {"source", "command", "reduced", "assumed"}
    unread = {f for f in _fields(cell["config_spec"])
              if f.split(".")[0] not in documents} - seen
    assert not unread


def test_configuration_is_the_programs_scene(config):
    """The reference's scene from cornell.json equals models.cornell.build's
    (its float32 tables) to float32 rounding: every sphere and triangle,
    material, colour, checker and texture coordinate, the light and the
    camera."""
    sc, cam, lights = ppm_specular.scene(config, 1.5)
    scene, pcam, plights = cornell.build(1.5, CPU)
    close = lambda got, want: np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=0, atol=2e-6)
    valid = scene.valid.numpy()
    close(scene.center.numpy()[valid], sc["sph_c"])
    close(scene.radius.numpy()[valid], sc["sph_r"])
    assert scene.mat_kind.numpy()[valid].tolist() == sc["sph_kind"].tolist()
    assert not scene.tex_kind.numpy()[valid].any() and not sc["sph_tex"].any()
    close(scene.color_a.numpy()[valid], sc["sph_ca"])
    glass = sc["sph_kind"] == scenes.MATERIALS["dielectric"]
    close(scene.ior.numpy()[valid][glass], sc["sph_ior"][glass])

    tp = scene.tri_pack.numpy()[scene.tri_valid.numpy()]
    assert len(tp) == len(sc["tri_a"]) == 18
    close(tp[:, TRI_A], sc["tri_a"])
    close(tp[:, TRI_E1], sc["tri_e1"])
    close(tp[:, TRI_E2], sc["tri_e2"])
    close(tp[:, TRI_TEX], sc["tri_uv"].reshape(-1, 6))
    assert tp[:, 15].tolist() == sc["tri_kind"].tolist()
    assert tp[:, 16].tolist() == sc["tri_tex"].tolist()
    close(tp[:, 17:20], sc["tri_ca"])
    checker = sc["tri_tex"] == 1
    assert checker.sum() == 2
    close(tp[checker, 20:23], sc["tri_cb"][checker])
    close(tp[checker, 23:25], sc["tri_cwh"][checker])

    (light,), (ref_light,) = plights, lights
    assert light.kind == "point"
    close(light.position, ref_light["position"])
    close(light.color, ref_light["flux"])
    np.testing.assert_allclose(pcam.look_at[:, :3], cam.rot, atol=1e-15)
    np.testing.assert_allclose(pcam.look_at[:, 3], cam.shift, atol=1e-15)
    assert pcam.lower_left_x == pytest.approx(-cam.half_w, rel=1e-15)
    assert pcam.lower_left_y == pytest.approx(-cam.half_h, rel=1e-15)
    assert not sc["sky"].any()
    lo, hi = ppm_specular.box(sc)
    plo, phi = scene.bbox()
    close(plo, lo)
    close(phi, hi)


def test_walk_counters_recount_the_eager_walk(port, monkeypatch):
    """ppm.walk_live equals the live lanes that the eye walk hands the
    intersector at each of its bounces, recounted from an eager walk of
    each iteration; ppm.walk_lanes is the walk's lanes x 4 bounces. Every
    pixel is live at bounce 0, and the specular walk keeps few."""
    rend, _, _, rec = port
    seen = []
    call = Intersector.__call__

    def spy(self, org, d, alive):
        seen.append(int(alive.sum()))
        return call(self, org, d, alive)

    monkeypatch.setattr(Intersector, "__call__", spy)
    eye = make_eye_pass(rend.camera, W, H, PARAMS["max_bounces"],
                        PARAMS["photon_count"], rend.scene)
    for i in range(PARAMS["iterations"]):
        eye.walk(i * W * H)
    its, bounces = PARAMS["iterations"], PARAMS["max_bounces"]
    lanes = -(-W * H // 1024) * 1024
    assert len(seen) == its * bounces and seen[0] == seen[bounces] == W * H
    assert 0 < seen[1] < W * H // 4
    assert rec.counts["ppm.walk_live"] == sum(seen)
    assert rec.counts["ppm.walk_lanes"] == its * lanes * bounces


def test_tiled_walk_counts_the_pixels(tmp_path):
    """A diffuse mesh scene's eye pass is the tile kernel's one bounce:
    ppm.walk_live is W x H an iteration, counted on the host, and
    ppm.walk_lanes the eye lanes (whole tile rows)."""
    verts, faces = icosphere(2, (328.0, 60.0, 150.0), 45.0)
    path = str(tmp_path / "icosphere.ply")
    meshes.write_ply(path, verts, faces)
    w = h = 32
    scene, cam, lights, mesh = ganesha.build(path, w / h, CPU)
    rend = PPMRenderer(scene, cam, lights, w, h, iterations=2,
                       photon_count=1024, verbose=False, mesh=mesh)
    tracing.reset()
    try:
        rend.render()
        rec = tracing.images()[-1]
    finally:
        tracing.reset()
    assert rend.tile_tensors(1) is not None
    assert rec.counts["ppm.walk_live"] == 2 * w * h
    assert rec.counts["ppm.walk_lanes"] == rec.counts["ppm.eye_lanes"] \
        == 2 * 1024
