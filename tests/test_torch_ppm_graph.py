"""The photon mapper's CUDA-graph path (pathtracer_tpu_torch.graph) on
the CPU, where no graph is captured: the photon pass and the eye walk take
their offsets as 0-dim int64 tensors (the graph's inputs) and give the int
form's outputs, and the graph module stays out of every render that is not
a photon-mapped render on a card with no group: a PPMRenderer on the CPU
never loads it, and neither does importing the scene models. The replay
itself needs the card (tests/test_torch_cuda.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch
from pathtracer_tpu_torch import ppm
from pathtracer_tpu_torch.models import cornell, ganesha
from pathtracer_tpu_torch.utils import tracing
from port_bench import meshes

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from tools.icosphere import icosphere  # noqa: E402

CPU = torch.device("cpu")
GRAPH_MODULE = "pathtracer_tpu_torch.graph"
W = H = 32
PHOTONS, BOUNCES = 1200, 3


def _ganesha(tmp_path):
    """The spot-lit icosphere of 320 triangles over the ganesha floor."""
    verts, faces = icosphere(2, (328.0, 60.0, 150.0), 45.0)
    path = str(tmp_path / "icosphere.ply")
    meshes.write_ply(path, verts, faces)
    return ganesha.build(path, W / H, CPU)


def _passes(kind, tmp_path):
    """(photon pass, eye pass) of a small scene: cornell (spheres and
    triangles, the specular walk of BOUNCES bounces) or the icosphere
    ganesha (the mesh walk, the tile kernel's eye pass)."""
    if kind == "cornell":
        scene, cam, lights = cornell.build(1.0, CPU)
        mesh, eff, tile = None, BOUNCES, None
    else:
        scene, cam, lights, mesh = _ganesha(tmp_path)
        rend = ppm.PPMRenderer(scene, cam, lights, W, H, mesh=mesh,
                               photon_count=PHOTONS, max_bounces=BOUNCES)
        eff, tile = 1, rend.tile_tensors(1)
    trace, _, _ = ppm.make_photon_pass(scene, lights, PHOTONS, BOUNCES, mesh)
    eye = ppm.make_eye_pass(cam, W, H, BOUNCES, PHOTONS, scene, eff, mesh,
                            tile)
    return trace, eye


def _bits(x):
    """x with float32 read as its bit patterns: the deposits of lanes that
    hit nothing hold NaN, which torch.equal never finds equal."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("kind", ["cornell", "ganesha"])
@pytest.mark.parametrize("offset", [3 * PHOTONS, 2 ** 31 + 7 * W * H])
def test_stages_take_the_offset_as_a_tensor(tmp_path, kind, offset):
    """deposits and walk at an int offset, and at the same offset as a
    0-dim int64 tensor: equal outputs bit for bit, each unlike offset 0's
    (the offset reaches the samples), past 2^31 too."""
    trace, eye = _passes(kind, tmp_path)
    as_tensor = torch.tensor(offset, dtype=torch.int64)
    for stage in (trace.deposits, eye.walk):
        want = stage(offset)
        got = stage(as_tensor)
        assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))
        assert not torch.equal(_bits(stage(0)[0]), _bits(want[0]))
    offs = trace.emit(as_tensor)[0]
    assert int(offs.max()) < 2 ** 32 and int(offs[0]) == offset & ppm.M32


class _Refuse:
    """A stand-in for the graph module that raises on any use."""

    def __getattr__(self, name):
        raise AssertionError(f"the graph module was used: {name}")


def test_a_cpu_render_never_touches_the_graph_module(tmp_path, monkeypatch):
    """With the graph module replaced by one that raises on any use, a
    PPMRenderer on the CPU renders twice and counts every iteration, none
    of them replayed, and opens no replay or capture span."""
    monkeypatch.setitem(sys.modules, GRAPH_MODULE, _Refuse())
    monkeypatch.setattr(pathtracer_tpu_torch, "graph", _Refuse(),
                        raising=False)
    scene, cam, lights, mesh = _ganesha(tmp_path)
    rend = ppm.PPMRenderer(scene, cam, lights, W, H, iterations=2,
                           photon_count=PHOTONS, max_bounces=BOUNCES,
                           verbose=False, mesh=mesh)
    tracing.reset()
    try:
        imgs = [rend.render(), rend.render()]
        recs = tracing.images()
    finally:
        tracing.reset()
    assert torch.equal(imgs[0], imgs[1]) and float(imgs[0].max()) > 0
    for rec in recs:
        assert rec.counts["ppm.iters"] == 2
        assert "ppm.graph_iters" not in rec.counts
        assert not {"ppm.replay", "ppm.capture"} & set(rec.total_ns)
    assert rend._graph is None


def test_a_fresh_process_renders_without_loading_the_graph_module(tmp_path):
    """In a process of its own (no other test's imports), importing the
    port's CLI and the ganesha, shirley and cornell models, then a
    PPMRenderer render on the CPU, leaves the graph module unloaded."""
    code = f"""
import pathlib
import sys
sys.path.insert(0, {ROOT!r})
import pathtracer_tpu_torch.cli
from pathtracer_tpu_torch.models import cornell, ganesha, shirley
assert {GRAPH_MODULE!r} not in sys.modules, "imports"
from tests.test_torch_ppm_graph import _ganesha, W, H
from pathtracer_tpu_torch.ppm import PPMRenderer
scene, cam, lights, mesh = _ganesha(pathlib.Path({str(tmp_path)!r}))
PPMRenderer(scene, cam, lights, W, H, iterations=1, photon_count=1200,
            max_bounces=2, verbose=False, mesh=mesh).render()
assert {GRAPH_MODULE!r} not in sys.modules, "a render on the CPU"
print("unloaded")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("unloaded")


def test_emission_uploads_no_constant_per_call(tmp_path, monkeypatch):
    """The lights' constants reach the device once, when the photon pass
    is built: emit() makes no torch.as_tensor of host data (a CUDA graph
    cannot capture an upload)."""
    _, _, lights, _ = _ganesha(tmp_path)
    scene, _, _ = cornell.build(1.0, CPU)
    trace, _, _ = ppm.make_photon_pass(scene, lights, PHOTONS, BOUNCES)
    made = []
    as_tensor = torch.as_tensor

    def spy(x, *a, **k):
        if isinstance(x, np.ndarray):
            made.append(x)
        return as_tensor(x, *a, **k)

    monkeypatch.setattr(torch, "as_tensor", spy)
    trace.emit(torch.tensor(5, dtype=torch.int64))
    assert made == []
