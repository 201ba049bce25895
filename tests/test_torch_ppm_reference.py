"""The benchmark's plain photon mapper (port_bench/reference/ppm.py)
against the port's PPMRenderer, on the CPU (the kernels' plain versions).

The scene is the ganesha-spots configuration with a small closed mesh made
here: an icosphere of 320 triangles where the ganesha camera looks, over
the checkered floor, lit by the configuration's two spot lights; 32x32, 2
iterations of 2,048 photons at 4 bounces. The port renders it from the
PLY file through models.ganesha.build, the reference from the same float32
vertices and faces.

Tolerances (the port computes in float32, the reference in float64; the
program's readings over seven yaws: image 2.8e-4-4.3e-4, segments 0 or 1
of ~6,900):
- image RMSE over the reference's RMS <= 2e-3: a photon's path parts from
  the reference's only where a ray grazes a triangle's edge or the mesh's
  outline, or a Russian roulette sample lies within float32 rounding of
  the albedo; the cone filter weighs a deposit at the radius's edge by 0,
  so the radius's rounding moves nothing;
- photon segments within 5e-4 of the reference's (3 segments): the same
  parted paths.
The reference in bfloat16 (its control) falls far outside both."""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.models import ganesha
from pathtracer_tpu_torch.ppm import PPMRenderer
from port_bench import compare, meshes, readings, spec
from port_bench.entries import ppm as entry_ppm
from port_bench.reference import ppm as ref_ppm

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from tools.icosphere import icosphere  # noqa: E402

CPU = torch.device("cpu")
W = H = 32
PARAMS = dict(iterations=2, photon_count=2048, alpha=2.0 / 3.0,
              max_bounces=4)
IMAGE_RMSE = 2e-3
SEGMENTS_GAP = 5e-4


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    verts, faces = icosphere(2, (328.0, 60.0, 150.0), 45.0)
    path = str(tmp_path_factory.mktemp("ppm_ref") / "icosphere.ply")
    meshes.write_ply(path, verts, faces)
    with open(os.path.join(ROOT, "port_bench", "configs",
                           "ganesha-spots.json")) as f:
        config = json.load(f)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    config.update(mesh=path, mesh_sha256=digest, mesh_triangles=len(faces),
                  mesh_vertices=len(verts))
    return path, verts, faces, config


@pytest.fixture(scope="module")
def port(mesh):
    scene, cam, lights, bvh = ganesha.build(mesh[0], W / H, CPU)
    rend = PPMRenderer(scene, cam, lights, W, H, verbose=False, mesh=bvh,
                       **PARAMS)
    img = (rend.render() / PARAMS["iterations"]).numpy()
    segments = int(sum(int(s) for s, _ in rend.iter_segments))
    return img, segments


def _reference(mesh, dtype):
    _, verts, faces, config = mesh
    sc, cam, lights = ref_ppm.scene(config, verts, faces, W / H)
    return ref_ppm.render(sc, cam, lights, W, H, device=CPU, dtype=dtype,
                          **PARAMS)


@pytest.fixture(scope="module")
def reference(mesh):
    return _reference(mesh, torch.float64)


def test_port_matches_the_reference(port, reference):
    got = compare.image_numbers(*port, *reference)
    assert float(np.sqrt(np.mean(reference[0] ** 2))) > 0.01
    assert reference[1] > 2 * 2047  # emission and bounces past it
    assert got["nonfinite_px"] == 0
    assert got["image_rmse"] <= IMAGE_RMSE, got
    assert got["segments_gap"] <= SEGMENTS_GAP, got


def test_bfloat16_reference_is_not_correct(mesh, reference):
    """The control: the same reference in bfloat16 (coordinates near 300
    resolve to 2 units there, against a radius of about 3) fails both."""
    got = compare.image_numbers(*_reference(mesh, torch.bfloat16),
                                *reference)
    assert got["image_rmse"] > IMAGE_RMSE, got
    assert got["segments_gap"] > SEGMENTS_GAP, got


@pytest.mark.parametrize("block", [ref_ppm.GATHER_PAIRS, 1000])
def test_gather_equals_brute_force(block, monkeypatch):
    """The reference's grid gather over clustered deposits and hits (many
    to a cell; hits outside the deposits' box too) equals the sum over
    every pair, in one block of pairs or in many."""
    monkeypatch.setattr(ref_ppm, "GATHER_PAIRS", block)
    g = torch.Generator().manual_seed(5)
    q = torch.rand(3000, 3, generator=g, dtype=torch.float64) * 4.0
    q[:1000] = q[:1000] * 0.1 + 1.0
    qn = torch.nn.functional.normalize(torch.randn(3000, 3, generator=g,
                                                   dtype=torch.float64), dim=1)
    qf = torch.rand(3000, 3, generator=g, dtype=torch.float64)
    p = torch.rand(500, 3, generator=g, dtype=torch.float64) * 5.0 - 0.5
    p[:200] = p[:200] * 0.1 + 1.0
    pn = torch.nn.functional.normalize(torch.randn(500, 3, generator=g,
                                                   dtype=torch.float64), dim=1)
    r = 0.3
    d = torch.cdist(p, q)
    ok = (d * d < r * r) & (pn @ qn.T > ref_ppm.NDOT_MIN)
    want = torch.where(ok, 1.0 - d / r, 0.0) @ qf
    got = ref_ppm.gather(p, pn, q, qn, qf, r)
    assert int(ok.sum()) > 10000
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_reference_refuses_a_specular_scene(mesh):
    _, verts, faces, config = mesh
    sc, cam, lights = ref_ppm.scene(config, verts, faces, W / H)
    sc["tri_kind"] = np.ones_like(sc["tri_kind"])
    with pytest.raises(ValueError, match="all-diffuse"):
        ref_ppm.render(sc, cam, lights, W, H, device=CPU, **PARAMS)


class _Reads(dict):
    """A configuration that records the path of every field read."""

    def __init__(self, data, seen, path=""):
        super().__init__(data)
        self._seen, self._path = seen, path

    def _wrap(self, key, value):
        path = f"{self._path}{key}"
        self._seen.add(path)
        if isinstance(value, dict):
            return _Reads(value, self._seen, path + ".")
        if isinstance(value, list) and value and isinstance(value[0], dict):
            return [_Reads(v, self._seen, path + "[].") for v in value]
        return value

    def __getitem__(self, key):
        return self._wrap(key, super().__getitem__(key))

    def __contains__(self, key):
        self._seen.add(f"{self._path}{key}")
        return super().__contains__(key)


def _fields(data, path=""):
    for k, v in data.items():
        if isinstance(v, dict):
            yield from _fields(v, f"{path}{k}.")
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            for item in v:
                yield from _fields(item, f"{path}{k}[].")
        else:
            yield f"{path}{k}"


def test_every_configuration_field_is_read(monkeypatch):
    """ganesha-spots.json: each field that is not documentation (source,
    command, reduced, assumed) is read by a run's inputs, the reference's
    scene and lights, or the control's precision."""
    cell = spec.cell("ganesha-ppm")
    seen = set()
    config = _Reads(cell["config_spec"], seen)
    monkeypatch.setattr(ref_ppm, "render", lambda *a, **k: None)
    traffic = dict(cell["traffic_spec"], width=8, height=8)
    entry_ppm.Inputs(config, traffic, 12345).reference("cpu")
    readings.CONTROL[config["precision"]]
    documents = {"source", "command", "reduced", "assumed"}
    unread = {f for f in _fields(cell["config_spec"])
              if f.split(".")[0] not in documents} - seen
    assert not unread
