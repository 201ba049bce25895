"""The mesh path tracer's CUDA-graph path (pathtracer_tpu_torch.graph) on
the CPU, where no graph is captured: the pass index as a 0-dim tensor
(the graph's input) gives the int form's primaries, and the graph module
stays out of every render that is not a mesh render on a card — the
shirley renders never load it, and a mesh render on the CPU neither. The
replay itself needs the card (tests/test_torch_cuda.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch
from pathtracer_tpu_torch.integrator import MeshRenderer, make_render_fn
from pathtracer_tpu_torch.io import ply
from pathtracer_tpu_torch.models import ganesha, shirley
from pathtracer_tpu_torch.utils import tracing

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from tools.make_test_mesh import uv_sphere  # noqa: E402

CPU = torch.device("cpu")
GRAPH_MODULE = "pathtracer_tpu_torch.graph"


def _tiny_ganesha(path):
    verts, faces = uv_sphere(12, 8, np.array([328.0, 60.0, 150.0]), 45.0)
    ply.write_mesh(path, verts, faces)
    return ganesha.build_pt(path, 1.0, CPU)


@pytest.mark.parametrize("pass_idx", [0, 3, 2 ** 29 + 5])
def test_primary_takes_the_pass_index_as_a_tensor(tmp_path, pass_idx):
    """The offsets (lane + pass * spp) & M32, wrapped past 2^32 at the
    last index (spp 8), and the rays from them are the int form's."""
    scene, cam, bg, mesh = _tiny_ganesha(str(tmp_path / "tiny.ply"))
    r = MeshRenderer(scene, cam, bg, 32, 32, 8, 2, CPU, mesh)
    want = r.primary(pass_idx)
    got = r.primary(torch.tensor(pass_idx, dtype=torch.int64))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if pass_idx > 2 ** 28:
        assert int(want[0].min()) < pass_idx * 8 - 2 ** 32 + 1024


class _Refuse:
    """A stand-in for the graph module that raises on any use."""

    def __getattr__(self, name):
        raise AssertionError(f"the graph module was used: {name}")


def _render(kind, tmp_path):
    if kind == "mesh_cpu":
        scene, cam, bg, mesh = _tiny_ganesha(str(tmp_path / "tiny.ply"))
        render = make_render_fn(cam, bg, 32, 32, 2, 3, CPU, mesh=mesh)
    else:
        scene, cam, bg = shirley.build(2.0, CPU)
        render = make_render_fn(cam, bg, 64, 32, 2, 4, CPU,
                                fuse_bounce=kind == "shirley")
    return render(scene)


@pytest.mark.parametrize("kind", ["shirley", "shirley_two_kernel",
                                  "mesh_cpu"])
def test_renders_off_the_card_never_touch_the_graph_module(tmp_path,
                                                           monkeypatch, kind):
    """With the graph module replaced by one that raises on any use, the
    shirley renders (fused and two-kernel) and the mesh render on the CPU
    finish and count their passes, none of them replayed."""
    monkeypatch.setitem(sys.modules, GRAPH_MODULE, _Refuse())
    monkeypatch.setattr(pathtracer_tpu_torch, "graph", _Refuse(),
                        raising=False)
    tracing.reset()
    try:
        img, segments = _render(kind, tmp_path)
        counts = tracing.images()[-1].counts
    finally:
        tracing.reset()
    assert segments > 0 and bool(torch.isfinite(img).all())
    assert "pt.graph_passes" not in counts
    assert counts["pt.passes"] == 2


def test_a_fresh_process_renders_shirley_without_loading_the_graph_module(
        tmp_path):
    """In a process of its own (no other test's imports), importing the
    port, its CLI and rendering shirley, then a mesh on the CPU, leaves
    the graph module unloaded."""
    code = f"""
import sys
import torch
sys.path.insert(0, {ROOT!r})
import pathtracer_tpu_torch.cli
from pathtracer_tpu_torch.integrator import make_render_fn
from pathtracer_tpu_torch.models import shirley
scene, cam, bg = shirley.build(2.0, torch.device("cpu"))
make_render_fn(cam, bg, 32, 32, 1, 3, torch.device("cpu"))(scene)
assert {GRAPH_MODULE!r} not in sys.modules, "shirley"
from tests.test_torch_mesh_graph import _render
import pathlib
_render("mesh_cpu", pathlib.Path({str(tmp_path)!r}))
assert {GRAPH_MODULE!r} not in sys.modules, "mesh on the CPU"
print("unloaded")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("unloaded")


def test_the_graph_module_counts_every_kernel_wrapper():
    """The launches a replay adds come from every ops.cuda wrapper with a
    `launches` count, the mesh pass's four among them."""
    from pathtracer_tpu_torch import graph
    from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw
    from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk
    from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk
    from pathtracer_tpu_torch.ops.cuda import tri_kernel as tk

    got = graph.kernel_wrappers()
    assert {sk.intersect_spheres, tk.intersect_tris, bw.bvh8_walk,
            bw.bvh4_walk, ttk.intersect_tile_tris} <= got
    assert all(isinstance(f.launches, int) for f in got)
