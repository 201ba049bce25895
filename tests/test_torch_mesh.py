"""Port parity of the mesh's host side: the PLY reader, the native BVH build
and BVH8 walk table (MeshBVH), the tile-culled triangle table and its lane
maps, and the tile frustum planes of pathtracer_tpu_torch against the JAX
package. Everything here is host numpy built by the same C++ (the port's
copy of native/bvh_build.cc), so every comparison is exact."""

import os
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu.io import ply as jply
from pathtracer_tpu.models import ganesha as jganesha
from pathtracer_tpu.ops import frustum as jfrustum
from pathtracer_tpu.ops.bvh import MeshBVH as JMeshBVH
from pathtracer_tpu.ops.pallas import tile_tri_kernel as jttk
from pathtracer_tpu_torch import native
from pathtracer_tpu_torch.io import ply
from pathtracer_tpu_torch.models import ganesha
from pathtracer_tpu_torch.ops import frustum
from pathtracer_tpu_torch.ops.bvh import MeshBVH
from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk

ROOT = os.path.join(os.path.dirname(__file__), "..")
TEST_PLY = os.path.join(ROOT, "scenes", "test_ganesha.ply")
CPU = torch.device("cpu")
sys.path.insert(0, ROOT)
from tools.make_test_mesh import uv_sphere  # noqa: E402


def test_ply_reader_equals_jax_and_round_trips(tmp_path):
    got, want = ply.load(TEST_PLY), jply.load(TEST_PLY)
    assert got.fmt == want.fmt == "binary_little_endian"
    assert [(e.name, e.count) for e in got.elements] == \
        [(e.name, e.count) for e in want.elements]
    for el, cols in want.data.items():
        for name, col in cols.items():
            np.testing.assert_array_equal(got.data[el][name], col)
    verts = np.stack([got.data["vertex"][k] for k in "xyz"], 1)
    faces = got.data["vertex_indices"]["vertex_indices"]
    path = str(tmp_path / "rt.ply")
    ply.write_mesh(path, verts, faces)
    back = ply.load(path)
    np.testing.assert_array_equal(
        np.stack([back.data["vertex"][k] for k in "xyz"], 1), verts)
    np.testing.assert_array_equal(
        back.data["vertex_indices"]["vertex_indices"], faces)
    with open(path, "rb") as f, open(str(tmp_path / "bad.ply"), "wb") as g:
        g.write(b"plx" + f.read()[3:])
    with pytest.raises(ply.PlyError):
        ply.load(str(tmp_path / "bad.ply"))


@pytest.fixture(scope="module")
def test_meshes():
    """test_ganesha.ply as the JAX (walk="bvh8") and the port's MeshBVH."""
    jcam = jganesha.make_camera(1.0)
    cam = ganesha.make_camera(1.0)
    return (jganesha.load_mesh(TEST_PLY, jcam),
            ganesha.load_mesh(TEST_PLY, cam, CPU))


def test_mesh_bvh_equals_jax_bit_for_bit(test_meshes):
    jm, m = test_meshes
    assert m.n_tris == jm.n_tris > 10_000
    assert (m.depth, m.node_end, m.stride) == (jm.depth, jm.node_end,
                                               jm.stride)
    assert m.watertight and jm.watertight
    for name in ("nodes_lo", "nodes_hi", "meta_np", "tri_a", "tri_e1",
                 "tri_e2", "mat_row", "bbox_lo", "bbox_hi"):
        a, b = getattr(m, name), np.asarray(getattr(jm, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(m.table_np.view(np.uint32),
                                  jm._table_np.view(np.uint32))
    assert m.leaf_histogram() == jm.leaf_histogram()
    # bits, not values: a node row's unused columns hold NaN
    assert torch.equal(m.table.view(torch.int32),
                       torch.from_numpy(jm._table_np.view(np.int32)))
    assert tuple(m.tri_pack9.shape) == (9, m.n_tris)
    assert torch.equal(m.tri_pack9[3:6].T, torch.from_numpy(m.tri_e1))
    assert torch.equal(m.mat_row_t, torch.from_numpy(np.asarray(jm.mat_row)))


def test_mesh_from_numpy_carries_the_jax_mesh(test_meshes):
    jm, m = test_meshes
    carried = MeshBVH.from_numpy(dict(
        nodes_lo=jm.nodes_lo, nodes_hi=jm.nodes_hi, meta_np=jm.meta_np,
        tri_a=jm.tri_a, tri_e1=jm.tri_e1, tri_e2=jm.tri_e2,
        mat_row=jm.mat_row, table=jm._table_np, node_end=jm.node_end,
        stride=jm.stride, depth=jm.depth, watertight=jm.watertight), CPU)
    assert torch.equal(carried.table.view(torch.int32),
                       m.table.view(torch.int32))
    for name in ("tri_pack9", "mat_row_t"):
        assert torch.equal(getattr(carried, name), getattr(m, name)), name
    assert (carried.node_end, carried.stride, carried.n_tris) == \
        (m.node_end, m.stride, m.n_tris)


def test_native_build_raises_past_the_24_bit_entries():
    """The BVH8 table past its 24-bit entry range raises (sized before any
    allocation: one leaf of 2^25 triangles); MeshBVH catches it and takes
    the BVH4 table (tests/test_torch_bvh4.py)."""
    zeros = np.zeros((0, 3), np.float32)
    with pytest.raises(ValueError, match="24-bit"):
        native.bvh8_table(np.zeros((1, 3), np.float32),
                          np.ones((1, 3), np.float32),
                          np.array([[0, 1 << 25, 1]], np.int32),
                          np.array([-1], np.int32), zeros, zeros, zeros)


@pytest.mark.parametrize("flip_y", [False, True])
def test_tile_frustum_planes_with_z_plane_equal_jax(flip_y):
    cam = ganesha.make_camera(1.5)
    jcam = jganesha.make_camera(1.5)
    for z in (False, True):
        got = frustum.tile_frustum_planes(cam, 96, 64, 3, 2, flip_y=flip_y,
                                          with_z_plane=z)
        want = jfrustum.tile_frustum_planes(jcam, 96, 64, 3, 2, flip_y=flip_y,
                                            with_z_plane=z)
        assert got.shape == (6, 5 if z else 4, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backface", [False, True])
def test_tile_tri_table_and_lane_maps_equal_jax(backface):
    """The tiny uv-sphere mesh under the ganesha camera at 64x64: the BVH
    cull (and the back-face cull) give the JAX table exactly."""
    verts, faces = uv_sphere(12, 8, np.array([328.0, 60.0, 150.0]), 45.0)
    w = h = 64
    jcam = jganesha.make_camera(1.0)
    cam = ganesha.make_camera(1.0)
    jm = JMeshBVH(jcam.transform_points(verts), faces, np.zeros(12),
                  walk="bvh8", watertight=True)
    m = MeshBVH(cam.transform_points(verts), faces, np.zeros(12), CPU,
                watertight=True)
    want = jttk.build_tile_tri_table(jcam, jm.tri_a, jm.tri_e1, jm.tri_e2,
                                     w, h, bvh=jm, backface_cull=backface)
    got = ttk.build_tile_tri_table(cam, m.tri_a, m.tri_e1, m.tri_e2, w, h,
                                   bvh=m, backface_cull=backface)
    assert (got.tx_n, got.ty_n, got.zero_chunk) == (want.tx_n, want.ty_n,
                                                    want.zero_chunk)
    for name in ("table", "tile_chunk_start", "tile_chunk_src"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(got.table[9].max()) > 0  # real lists, not only zero chunks
    for width, rows in ((64, 64), (40, 32), (600, 608)):
        tx_n = -(-width // 32)
        for a, b in zip(ttk.lane_maps(width, rows, tx_n),
                        jttk.lane_maps(width, rows, tx_n)):
            np.testing.assert_array_equal(a, b)
