"""The ganesha-pt-1.8m cell's mesh and its path on the CPU: the benchmark's
4:1 midpoint split (entries/pt_subdivided.split), the entry's checks of
the committed file and of the split's sizes, and a small split mesh
forced onto the BVH4 table, rendered by the port through make_render_fn
(the kernels' plain versions) against the benchmark's float64 reference
within the cell's limits, with the walk's counters of the image.

The small mesh is an icosphere of 320 triangles where the ganesha camera
looks (1,280 after the split), over the checkered floor under the
shirley sky: 32x32, 2 samples a pixel, 4 bounces. The program's reading
is ~3.4e-8 of the reference's RMS with the segments equal; the mesh
moved out of view reads 0.65 and the bfloat16 control 0.37, so the
image shows the mesh and the limits tell the two apart."""

import functools
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator import make_render_fn
from pathtracer_tpu_torch.models import ganesha
from pathtracer_tpu_torch.ops.bvh import MeshBVH
from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw
from pathtracer_tpu_torch.utils import tracing
from port_bench import compare, meshes, readings, spec
from port_bench.entries import pt_subdivided as ps

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from tools.icosphere import icosphere  # noqa: E402

CELL = "ganesha-pt-1.8m"
SEED = 2_718_281_829
TRAFFIC = dict(entry="pt_subdivided", width=32, height=32, spp=2,
               max_bounces=4)


def _edges(faces):
    """The undirected edges of faces (F, 3), as sorted pairs, with each
    one's count of faces."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    return np.unique(np.sort(e, axis=1), axis=0, return_counts=True)


def test_split_gives_four_faces_a_face_on_shared_midpoints():
    verts, faces = icosphere(1, (0.0, 0.0, 0.0), 2.0)
    v2, f2 = ps.split(verts, faces)
    n, nf = len(verts), len(faces)
    edges, _ = _edges(faces)
    assert f2.shape == (4 * nf, 3) and v2.dtype == np.float64
    assert len(v2) == n + len(edges)  # one new vertex an edge
    assert np.array_equal(v2[:n], verts.astype(np.float64))
    # each midpoint is its edge's, and the faces on both sides share it
    mid = 0.5 * (v2[edges[:, 0]] + v2[edges[:, 1]])
    assert np.array_equal(np.sort(mid, axis=0), np.sort(v2[n:], axis=0))
    for f in range(nf):
        a, b, c = faces[f]
        kids = f2[[f, nf + f, 2 * nf + f, 3 * nf + f]]
        m01, m12, m20 = kids[3]
        assert np.array_equal(kids[:3], [[a, m01, m20], [m01, b, m12],
                                         [m20, m12, c]])
        for (p, q), m in (((a, b), m01), ((b, c), m12), ((c, a), m20)):
            assert np.array_equal(v2[m], 0.5 * (v2[p] + v2[q]))


def test_split_keeps_a_closed_surface_closed_and_is_deterministic():
    verts, faces = icosphere(2, (1.0, 2.0, 3.0), 5.0)
    assert (_edges(faces)[1] == 2).all()
    v2, f2 = ps.split(verts, faces)
    _, counts = _edges(f2)
    assert (counts == 2).all()  # every edge still between two faces
    assert len(v2) - len(counts) + len(f2) == 2  # Euler: still a sphere
    # every new triangle keeps its parent's winding (normals agree)
    nrm = lambda v, f: np.cross(v[f[:, 1]] - v[f[:, 0]],
                                v[f[:, 2]] - v[f[:, 0]])
    parent = np.tile(nrm(verts.astype(np.float64), faces), (4, 1))
    assert ((nrm(v2, f2) * parent).sum(1) > 0).all()
    again = ps.split(verts.copy(), faces.copy())
    assert np.array_equal(again[0], v2) and np.array_equal(again[1], f2)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The icosphere's PLY and a copy of the cell's configuration that
    names it, with its digest and its and the split's sizes."""
    verts, faces = icosphere(2, (328.0, 25.0, 150.0), 45.0)
    path = str(tmp_path_factory.mktemp("sub4") / "icosphere.ply")
    meshes.write_ply(path, verts, faces)
    config = dict(spec.cell(CELL)["config_spec"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    v2, f2 = ps.split(verts, faces)
    config.update(mesh=path, mesh_sha256=digest, mesh_triangles=len(faces),
                  mesh_vertices=len(verts), subdivided_triangles=len(f2),
                  subdivided_vertices=len(v2))
    return config


@pytest.mark.parametrize("key, value", [
    ("mesh_sha256", "0" * 64), ("mesh_triangles", 321),
    ("mesh_vertices", 161), ("subdivided_triangles", 1281),
    ("subdivided_vertices", 641)])
def test_entry_refuses_another_file_or_other_sizes(small, key, value):
    with pytest.raises(ValueError, match="sha256|triangles"):
        ps.Inputs(dict(small, **{key: value}), TRAFFIC, SEED)


def test_cell_inputs_are_the_committed_mesh_split_and_yawed():
    """The cell's own configuration: big_ganesha.ply split once, 1,797,408
    triangles on 899,652 float32 vertices, turned by the seed's yaw."""
    c = spec.cell(CELL)
    config = c["config_spec"]
    assert (config["subdivide"], config["subdivided_triangles"],
            config["subdivided_vertices"]) == (1, 1_797_408, 899_652)
    assert c["traffic_spec"]["entry"] == "pt_subdivided"
    inputs = ps.Inputs(config, c["traffic_spec"], SEED)
    assert inputs.faces.shape == (1_797_408, 3)
    assert inputs.verts.shape == (899_652, 3)
    assert inputs.verts.dtype == np.float32
    plain = meshes.read_ply(os.path.join(ROOT, config["mesh"]))
    v64, faces = ps.split(*plain)
    assert np.array_equal(inputs.faces, faces)
    assert np.array_equal(inputs.verts, meshes.yawed(v64, SEED))


def test_mesh_bvh_owns_walk_counters_on_bvh4_only():
    verts, faces = icosphere(1, (0.0, 0.0, 0.0), 2.0)
    m8 = MeshBVH(verts, faces, np.zeros(12, np.float32), "cpu")
    m4 = MeshBVH(verts, faces, np.zeros(12, np.float32), "cpu", walk="bvh4")
    assert m8.walk == "bvh8" and m8.walk_counts is None
    assert m4.walk_counts.dtype == torch.int64
    assert m4.walk_counts.tolist() == [0, 0]
    n = 64
    org = torch.full((n, 3), 10.0)
    d = -org / org.norm(dim=1, keepdim=True)
    active = torch.arange(n) % 3 != 0
    m4.intersect(org, d, torch.full((n,), 1e30), active)
    assert m4.walk_counts.tolist() == [int(active.sum()), 0]
    with pytest.raises(ValueError, match="counts"):
        bw.bvh4_walk(m4.table, org, d, torch.full((n,), 1e30), active,
                     m4.node_end, m4.stride,
                     torch.zeros(2, dtype=torch.int32))


def test_small_split_mesh_on_bvh4_matches_the_reference(small, monkeypatch):
    """The entry's program side on BVH4 through make_render_fn: each image
    within the cell's limits of the float64 reference, its pt.walk_rays
    the rays the walks took (every live lane past bounce 0, which meets
    the mesh through the tile kernel), the same for a second image of the
    kept renderer, and no pt.walk_loads off the card; the bfloat16
    control fails the limits."""
    monkeypatch.setattr(ganesha, "MeshBVH",
                        functools.partial(MeshBVH, walk="bvh4"))
    built = []
    real = make_render_fn

    def record(*a, **k):
        built.append(k["mesh"])
        return real(*a, **k)

    monkeypatch.setattr("pathtracer_tpu_torch.integrator.make_render_fn",
                        record)
    tracing.reset()
    entry = ps.Entry(small, TRAFFIC, SEED, "cpu")
    try:
        assert built[0].walk == "bvh4"
        assert entry.sizes() == {"spheres": 0, "mesh_triangles": 1280}
        shots = [entry.image() for _ in range(2)]
        records = tracing.images()
        ref = entry.inputs.reference("cpu")
    finally:
        entry.release()
        tracing.reset()
    limits = spec.cell(CELL)["limits"]
    w, h, spp = TRAFFIC["width"], TRAFFIC["height"], TRAFFIC["spp"]
    for (img, segs), rec in zip(shots, records):
        got = compare.image_numbers(img, segs, *ref)
        assert compare.judge([got], limits)[1] == 0, got
        assert rec.counts["pt.walk_rays"] == segs - w * h * spp > 0
        assert "pt.walk_loads" not in rec.counts
    assert shots[0][1] == shots[1][1]
    ctl = entry.inputs.reference("cpu", readings.CONTROL[
        small["precision"]], max_walk_steps=5000)
    assert compare.judge([compare.image_numbers(*ctl, *ref)],
                         limits)[1] == 1


def test_cell_files_name_each_other():
    bench = spec.benchmark()
    row = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (row["config"], row["traffic"], row["chips"]) == (
        "ganesha-1.8m", "pt8-sub4", 1)
    conf = next(c for c in bench["configs"] if c["name"] == "ganesha-1.8m")
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "port_bench", "configs",
                           "ganesha.json")) as f:
        base = json.load(f)
    for key in ("scene", "mesh", "mesh_sha256", "mesh_triangles",
                "mesh_vertices", "mesh_material", "floor", "camera", "sky",
                "ior", "precision", "reduced"):
        assert config[key] == base[key], key
    assert len(conf["source"]) <= 200 and conf["reduced"] == ["mesh"]
    with open(os.path.join(ROOT, "port_bench", "traffic", "pt8.json")) as f:
        pt8 = json.load(f)
    c = spec.cell(CELL)
    assert c["traffic_spec"] == dict(pt8, entry="pt_subdivided")
    names = {m["name"] for m in c["per_layer"]}
    assert {"walk4_roofline", "pt_driver.walk_loads_per_ray",
            "build.mesh_bvh_s", "build.scene_s",
            "device.idle_pct"} <= names
