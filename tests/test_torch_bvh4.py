"""The BVH4 walk of pathtracer_tpu_torch on the CPU against the JAX
package: the native BVH4 table (bit for bit), MeshBVH's walk choice and its
fallback from BVH8 past the 24-bit entries, the plain BVH4 walk
(bvh4_walk_plain, what the wrapper runs for CPU tensors) against the JAX
BVH4 MeshBVH.intersect, and the tiny ganesha's path-traced render and
photon pass with the mesh forced onto BVH4 in both packages. The plain
emulation of csrc/bvh4_walk.cu (bvh4_walk_cached_plain: its path cache of
node rows and its leaf step of two pair rows) against bvh4_walk_plain and
the JAX walk, and its leaf combine (_leaf_quad) against four sequential
triangle updates.

Inputs: tests/test_torch_bvh_walk.py's random soup and its 1,111 random
rays plus 64 rays with exact-zero direction components (the NaN box-plane
case); a soup of 60 triangles each repeated 1-8 times (exact ties in t
inside a leaf, leaves of 1-4 pair rows) and scenes/test_ganesha.ply
(99,904 triangles), each with 1,500 rays leaving its surface (on the tie
soup 375 of them aimed at it; a quarter inactive, t_max0 3 or 1e30) and
256 axis-aligned rays; scenes/big_ganesha.ply
subdivided 4:1 at its edge midpoints (1,797,408 triangles, past the BVH8
table's 2^24 / 8 rows); the tiny ganesha of tests/test_torch_ganesha_pt.py
(a 168-triangle uv-sphere over the floor).

Tolerances, each the one of the BVH8 test this mirrors: tables equal bit
for bit (one C++ source); the walk's hit and idx equal on every lane, t to
rtol 5e-6 plus atol 1e-6, u and v to atol 5e-5 (XLA on the CPU contracts
the Moller-Trumbore products into FMAs, test_torch_bvh_walk.py); the
render's segments equal and its image to rtol 1e-3 / atol 1e-4
(test_torch_ganesha_pt.py); the photon pass's valid masks and flux equal,
positions to 1e-4 of the deposit's largest coordinate, normals to atol
1e-5 (test_torch_ganesha.py)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import native as jnative
from pathtracer_tpu.integrator import make_render_fn as jmake_render_fn
from pathtracer_tpu.io import ply as jply
from pathtracer_tpu.models import ganesha as jganesha
from pathtracer_tpu.ops.bvh import MeshBVH as JMeshBVH
from pathtracer_tpu.ppm import make_photon_pass as jmake_photon_pass
from pathtracer_tpu_torch import native
from pathtracer_tpu_torch.integrator import make_render_fn
from pathtracer_tpu_torch.io import ply
from pathtracer_tpu_torch.models import ganesha
from pathtracer_tpu_torch.ops import bvh
from pathtracer_tpu_torch.ops.bvh import MeshBVH
from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw
from pathtracer_tpu_torch.ppm import make_photon_pass
from test_torch_bvh_walk import _mesh, _rays

ROOT = os.path.join(os.path.dirname(__file__), "..")
TEST_PLY = os.path.join(ROOT, "scenes", "test_ganesha.ply")
BIG_PLY = os.path.join(ROOT, "scenes", "big_ganesha.ply")
CPU = torch.device("cpu")
W = H = 64
sys.path.insert(0, ROOT)
from tools.make_test_mesh import uv_sphere  # noqa: E402


def _ply_mesh(path):
    """(vertices f64, faces int64) of a triangle PLY."""
    p = ply.load(path)
    verts = np.stack([np.asarray(p.data["vertex"][k], np.float64)
                      for k in "xyz"], axis=1)
    return verts, np.asarray(p.data["vertex_indices"]["vertex_indices"],
                             np.int64)


def subdivide(verts, faces):
    """4:1 midpoint subdivision: one new vertex per undirected edge, so a
    closed surface stays closed. Returns (vertices, 4 F faces)."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    n = len(verts)
    key = np.minimum(e[:, 0], e[:, 1]) * n + np.maximum(e[:, 0], e[:, 1])
    uniq, inv = np.unique(key, return_inverse=True)
    mids = 0.5 * (verts[uniq // n] + verts[uniq % n])
    m01, m12, m20 = (n + inv).reshape(3, -1)
    a, b, c = faces.T
    out = [np.stack(t, axis=1) for t in ((a, m01, m20), (m01, b, m12),
                                         (m20, m12, c), (m01, m12, m20))]
    return np.concatenate([verts, mids]), np.concatenate(out)


def _tables(verts, faces):
    """The native build's arguments to the walk tables, in BVH order."""
    verts = np.asarray(verts, np.float32)
    a, b, c = (verts[faces[:, k]] for k in range(3))
    lo = np.minimum(np.minimum(a, b), c)
    hi = np.maximum(np.maximum(a, b), c)
    nodes_lo, nodes_hi, meta, order, _, axes = native.bvh_build(lo, hi)
    a, b, c = a[order], b[order], c[order]
    return nodes_lo, nodes_hi, meta, axes, a, b - a, c - a


@pytest.mark.parametrize("mesh", ["soup", "test_ganesha"])
def test_native_bvh4_table_equals_jax(mesh):
    verts, faces = _mesh() if mesh == "soup" else _ply_mesh(TEST_PLY)
    args = _tables(verts, faces)
    table, node_end, stride = native.bvh4_table(*args)
    want, want_end, want_stride = jnative.bvh4_table_native(*args)
    assert (node_end, stride) == (want_end, want_stride)
    assert node_end == 8 * stride
    np.testing.assert_array_equal(table.view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    assert table.shape[0] > node_end + len(faces) // 2
    assert bvh.build_walk_table4(*args)[0].tobytes() == table.tobytes()


def test_native_bvh4_table_raises_past_int32_pointers():
    """Pointers are int32 row*4 + phase: a table of 2^29 rows or more
    raises, sized before any allocation (one leaf of 2^30 triangles)."""
    zeros = np.zeros((0, 3), np.float32)
    with pytest.raises(ValueError, match="int32"):
        native.bvh4_table(np.zeros((1, 3), np.float32),
                          np.ones((1, 3), np.float32),
                          np.array([[0, 1 << 30, 1]], np.int32),
                          np.array([-1], np.int32), zeros, zeros, zeros)


@pytest.fixture(scope="module")
def soup_meshes():
    """The random soup as the JAX MeshBVH(walk="bvh4") and the port's
    MeshBVH carried across from it."""
    verts, faces = _mesh()
    jm = JMeshBVH(verts, faces, np.zeros(12, np.float32), walk="bvh4")
    assert jm._walk_args[0] == "bvh4"
    m = MeshBVH.from_numpy(dict(
        nodes_lo=jm.nodes_lo, nodes_hi=jm.nodes_hi, meta_np=jm.meta_np,
        tri_a=jm.tri_a, tri_e1=jm.tri_e1, tri_e2=jm.tri_e2,
        mat_row=jm.mat_row, table=jm._table_np, node_end=jm.node_end,
        stride=jm.stride, depth=jm.depth, watertight=False, walk="bvh4"),
        CPU)
    return jm, m


def test_plain_bvh4_walk_matches_jax_walk(soup_meshes):
    jm, m = soup_meshes
    org, d, t_max, active = _rays(jm.bbox_lo)
    want = [np.asarray(x) for x in jm.intersect(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(t_max),
        jnp.asarray(active))]
    got = [x.numpy() for x in m.intersect(
        torch.from_numpy(org), torch.from_numpy(d), torch.from_numpy(t_max),
        torch.from_numpy(active))]
    t, u, v, idx, hit = got
    jt, ju, jv, jidx, jhit = want
    assert idx.dtype == np.int32 and hit.dtype == bool
    np.testing.assert_array_equal(hit, jhit)
    np.testing.assert_array_equal(idx, jidx)
    assert 100 < int(hit.sum()) < len(hit) - 100
    assert int(hit[1111:].sum()) > 4  # some axis-aligned rays hit
    assert not hit[~active].any()
    np.testing.assert_allclose(t, jt, rtol=5e-6, atol=1e-6)
    np.testing.assert_allclose(u, ju, atol=5e-5)
    np.testing.assert_allclose(v, jv, atol=5e-5)


def test_plain_bvh4_walk_lanes_are_independent(soup_meshes):
    """A subset of the lanes walks to the same results as the whole set
    (what the card's checks on a few rays rely on), the step counts are
    those of finished walks, and the BVH4 walk finds the BVH8 walk's
    nearest hits on the same soup."""
    _, m = soup_meshes
    org, d, t_max, active = (torch.from_numpy(x) for x in _rays(m.bbox_lo))
    full = bw.bvh4_walk_plain(m.table, org, d, t_max, active, m.node_end,
                              m.stride, count_steps=True)
    sub = slice(5, None, 3)
    part = bw.bvh4_walk_plain(m.table, org[sub], d[sub], t_max[sub],
                              active[sub], m.node_end, m.stride,
                              check_every=1)
    for a, b in zip(full[:5], part):
        assert torch.equal(a[sub], b)
    steps, visited = full[5:]
    assert int(steps[~active].max()) == 0
    assert int(steps[active, 0].min()) >= 1  # every walk enters its root
    assert bool((steps[full[4], 1] >= 1).all())
    assert 0 < int(visited.sum()) <= m.table.shape[0] - 1
    m8 = MeshBVH(*_mesh(), np.zeros(12, np.float32), CPU)
    assert m8.walk == "bvh8"
    hit8 = m8.intersect(org, d, t_max, active)
    assert torch.equal(hit8[4], full[4])
    assert torch.equal(hit8[3][full[4]], full[3][full[4]])


def test_bvh4_walk_wrapper_refuses_malformed_input(soup_meshes):
    _, m = soup_meshes
    org = torch.zeros(8, 3)
    counts = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="bvh4_walk"):  # t_max0 too short
        bw.bvh4_walk(m.table, org, org, torch.zeros(7),
                     torch.ones(8, dtype=torch.bool), m.node_end, m.stride,
                     counts)
    with pytest.raises(ValueError, match="bvh4_walk"):  # active not bool
        bw.bvh4_walk(m.table, org, org, torch.zeros(8), torch.ones(8),
                     m.node_end, m.stride, counts)


@pytest.mark.parametrize("walk", ["octant", "skiplink", "bvh2"])
def test_mesh_bvh_refuses_other_walks(walk):
    verts, faces = _mesh()
    with pytest.raises(ValueError, match="walk"):
        MeshBVH(verts, faces, np.zeros(12, np.float32), CPU, walk=walk)


def test_from_numpy_round_trips_walk(soup_meshes):
    """from_numpy keeps the kind it is given, defaults to bvh8 for the
    dicts of callers that name none, and refuses other kinds."""
    _, m = soup_meshes
    arrays = dict(nodes_lo=m.nodes_lo, nodes_hi=m.nodes_hi,
                  meta_np=m.meta_np, tri_a=m.tri_a, tri_e1=m.tri_e1,
                  tri_e2=m.tri_e2, mat_row=m.mat_row, table=m.table_np,
                  node_end=m.node_end, stride=m.stride, depth=m.depth,
                  watertight=m.watertight)
    assert MeshBVH.from_numpy(dict(arrays, walk=m.walk), CPU).walk == "bvh4"
    m8 = MeshBVH(*_mesh(), np.zeros(12, np.float32), CPU)
    assert MeshBVH.from_numpy(dict(arrays, table=m8.table_np,
                                   node_end=m8.node_end, stride=m8.stride),
                              CPU).walk == "bvh8"
    with pytest.raises(ValueError, match="walk"):
        MeshBVH.from_numpy(dict(arrays, walk="octant"), CPU)


def test_mesh_past_the_bvh8_range_falls_back_to_bvh4():
    """big_ganesha subdivided 4:1 (1,797,408 triangles): the BVH8 table
    raises, MeshBVH(walk="bvh8") takes BVH4, and its table, node_end and
    stride equal the JAX MeshBVH(walk="bvh8")'s, which falls back too. On
    the CPU: no table is uploaded to a device."""
    verts, faces = subdivide(*_ply_mesh(BIG_PLY))
    assert len(faces) == 1_797_408
    m = MeshBVH(verts, faces, np.zeros(12, np.float32), CPU, watertight=True)
    assert m.walk == "bvh4" and m.n_tris == len(faces)
    with pytest.raises(ValueError, match="24-bit"):
        native.bvh8_table(m.nodes_lo, m.nodes_hi, m.meta_np,
                          np.full(len(m.meta_np), -1, np.int32), m.tri_a,
                          m.tri_e1, m.tri_e2)
    jm = JMeshBVH(verts, faces, np.zeros(12, np.float32), walk="bvh8",
                  watertight=True)
    assert jm._walk_args[0] == "bvh4"
    assert (m.node_end, m.stride) == (jm.node_end, jm.stride)
    assert m.table_np.shape[0] > 2 ** 24 // 8
    np.testing.assert_array_equal(m.table_np.view(np.uint32),
                                  jm._table_np.view(np.uint32))


@pytest.fixture(scope="module")
def tiny_ply(tmp_path_factory):
    verts, faces = uv_sphere(12, 8, np.array([328.0, 60.0, 150.0]), 45.0)
    path = str(tmp_path_factory.mktemp("bvh4") / "tiny_ganesha.ply")
    jply.write_mesh(path, verts, faces)
    return path


@pytest.fixture
def force_bvh4(monkeypatch):
    """Both packages' ganesha models build their meshes with walk="bvh4",
    as a mesh past the BVH8 range does."""
    monkeypatch.setattr(jganesha, "MeshBVH", lambda *a, **k: JMeshBVH(
        *a, **dict(k, walk="bvh4")))
    monkeypatch.setattr(ganesha, "MeshBVH", lambda *a, **k: MeshBVH(
        *a, **dict(k, walk="bvh4")))


def test_tiny_bvh4_render_matches_jax_render(tiny_ply, force_bvh4):
    """build_pt with the BVH4 walk in both packages, make_render_fn(...,
    mesh=mesh) at 64x64, spp 2, 4 bounces: segments equal, the image to
    rtol 1e-3 / atol 1e-4, and the walk is the BVH4 one."""
    jscene, jcam, jbg, jmesh = jganesha.build_pt(tiny_ply, 1.0)
    scene, cam, bg, mesh = ganesha.build_pt(tiny_ply, 1.0, CPU)
    assert jmesh._walk_args[0] == mesh.walk == "bvh4"
    np.testing.assert_array_equal(mesh.table_np.view(np.uint32),
                                  jmesh._table_np.view(np.uint32))
    want, want_segs = jmake_render_fn(jcam, jbg, W, H, 2, 4,
                                      mesh=jmesh)(jscene)
    img, segs = make_render_fn(cam, bg, W, H, 2, 4, CPU, mesh=mesh)(scene)
    assert segs == int(want_segs) > 2 * W * H
    assert np.isfinite(img.numpy()).all()
    np.testing.assert_allclose(img.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)


def test_tiny_bvh4_photon_pass_matches_jax(tiny_ply, force_bvh4):
    """The photon pass of the tiny ganesha (1,000 photons, 3 bounces)
    through the BVH4 walk in both packages: valid masks and flux equal,
    positions to 1e-4 of the deposit's largest coordinate, normals to
    1e-5."""
    jscene, _, jlights, jmesh, _ = jganesha.build(tiny_ply, 1.0)
    scene, _, lights, mesh = ganesha.build(tiny_ply, 1.0, CPU)
    assert jmesh._walk_args[0] == mesh.walk == "bvh4"
    jtrace, _, _ = jmake_photon_pass(jscene, jlights, 1000, 3, "xla",
                                     mesh=jmesh)
    jpos, jnrm, jflux, jok = (np.asarray(x) for x in jtrace(0))
    trace, _, _ = make_photon_pass(scene, lights, 1000, 3, mesh)
    pos, nrm, flux, ok, _ = (x.numpy() for x in trace(0))
    np.testing.assert_array_equal(ok, jok)
    assert int(ok.sum()) > 500
    err = np.abs(pos[ok] - jpos[ok]).max(axis=1)
    assert (err <= 1e-4 * np.abs(jpos[ok]).max(axis=1)).all()
    np.testing.assert_array_equal(flux[ok], jflux[ok])
    np.testing.assert_allclose(nrm[ok], jnrm[ok], atol=1e-5)


def _tie_mesh(copies=(1, 8), n=60, seed=9):
    """A soup of n random triangles, each repeated 1-8 times (`copies`):
    a leaf holds one triangle's copies, so the leaf step meets exact ties
    in t, and leaves of 1-4 pair rows. Returns (vertices, faces)."""
    rs = np.random.RandomState(seed)
    verts = rs.uniform(-5, 5, (3 * n, 3))
    base = np.arange(3 * n).reshape(n, 3)
    faces = np.repeat(base, rs.randint(copies[0], copies[1] + 1, n), axis=0)
    return verts, faces[rs.permutation(len(faces))]


def _surface_rays(verts, faces, lo, hi, aimed, n=1500, nz=256, seed=13):
    """n rays from just off random points of random triangles in uniform
    random directions (t_max0 1e30 or 3, a quarter inactive; bounce rays'
    kind),
    the first `aimed` of them from the box around [lo, hi] aimed at a
    triangle's point instead, and nz rays with
    exact-zero direction components from inside [lo, hi], half of them on
    its low plane of a zeroed axis (0 * inf on a box plane)."""
    rs = np.random.RandomState(seed)
    w = rs.dirichlet([1, 1, 1], n)
    tri = verts[faces[rs.randint(0, len(faces), n)]]
    org = np.einsum("nk,nkc->nc", w, tri)
    d = rs.randn(n, 3)
    aim = np.einsum("nk,nkc->nc", rs.dirichlet([1, 1, 1], n),
                    verts[faces[rs.randint(0, len(faces), n)]])
    # off the surface by 0.1% of the box, so no t lies near 0 (where XLA's
    # FMAs could flip the t >= 0 test)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org += 1e-3 * float(np.max(hi - lo)) * d
    org[:aimed] = lo + rs.rand(aimed, 3) * (hi - lo) * 3 - (hi - lo)
    d[:aimed] = aim[:aimed] - org[:aimed]
    o2 = lo + rs.rand(nz, 3) * (hi - lo)
    d2 = rs.randn(nz, 3)
    for i in range(nz):
        axes = [i % 3] if i % 2 else [i % 3, (i + 1) % 3]
        d2[i, axes] = 0.0
        if i >= nz // 2:
            o2[i, axes[0]] = lo[axes[0]]
    t_max = np.concatenate([np.where(rs.rand(n) < 0.5, 3.0, 1e30),
                            np.full(nz, 1e30)])
    active = np.concatenate([rs.rand(n) > 0.25, np.ones(nz, bool)])
    return (np.concatenate([org, o2]).astype(np.float32),
            np.concatenate([d, d2]).astype(np.float32),
            t_max.astype(np.float32), active)


@pytest.fixture(scope="module", params=["soup", "ties", "test_ganesha"])
def cached_case(request):
    """A mesh on the JAX MeshBVH(walk="bvh4") and the port's MeshBVH
    carried across from it, its rays (the soup's _rays; _surface_rays on
    the tie soup and test_ganesha) and the JAX walk's results, once per
    module."""
    if request.param == "test_ganesha":
        verts, faces = _ply_mesh(TEST_PLY)
    else:
        verts, faces = _tie_mesh() if request.param == "ties" else _mesh()
    jm = JMeshBVH(verts, faces, np.zeros(12, np.float32), walk="bvh4")
    m = MeshBVH.from_numpy(dict(
        nodes_lo=jm.nodes_lo, nodes_hi=jm.nodes_hi, meta_np=jm.meta_np,
        tri_a=jm.tri_a, tri_e1=jm.tri_e1, tri_e2=jm.tri_e2,
        mat_row=jm.mat_row, table=jm._table_np, node_end=jm.node_end,
        stride=jm.stride, depth=jm.depth, watertight=False, walk="bvh4"),
        CPU)
    # the tie soup's rays aim at its triangles, so that they meet the ties;
    # test_ganesha's leave its surface only (an aimed ray may graze one of
    # its slivers, where XLA's FMAs move u by 1e-3)
    rays = (_rays(jm.bbox_lo) if request.param == "soup" else _surface_rays(
        np.asarray(verts, np.float32), faces, m.bbox_lo, m.bbox_hi,
        aimed=375 if request.param == "ties" else 0))
    want = [np.asarray(x) for x in jm.intersect(*map(jnp.asarray, rays))]
    return request.param, m, [torch.from_numpy(x) for x in rays], want


def test_cached_walk_equals_plain_and_jax_walk(cached_case):
    """bvh4_walk_cached_plain (the kernel's path cache and two-row leaf
    step) equals bvh4_walk_plain bit for bit and the JAX BVH4 walk to this
    file's tolerances, and its counts add up to the plain walk's steps:
    node rows = table loads - leaf steps + cache hits, pair rows = leaf
    steps + two-row steps."""
    name, m, rays, want = cached_case
    args = (m.table, *rays, m.node_end, m.stride)
    *plain, steps, _ = bw.bvh4_walk_plain(*args, count_steps=True)
    *got, counts = bw.bvh4_walk_cached_plain(*args)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    t, u, v, idx, hit = (x.numpy() for x in got)
    jt, ju, jv, jidx, jhit = want
    np.testing.assert_array_equal(hit, jhit)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(t, jt, rtol=5e-6, atol=1e-6)
    np.testing.assert_allclose(u, ju, atol=5e-5)
    np.testing.assert_allclose(v, jv, atol=5e-5)
    active = rays[3]
    assert int(hit.sum()) > 100 and not hit[~active.numpy()].any()
    nz = 64 if name == "soup" else 256
    assert int(hit[-nz:].sum()) > 2  # some axis-aligned rays hit
    loads, hits, misses, two = counts.unbind(1)
    leaf_steps = steps[:, 1] - two
    assert torch.equal(steps[:, 0], loads - leaf_steps + hits)
    assert bool((leaf_steps >= 0).all()) and int(counts[~active].max()) == 0
    # the cache serves most returns (on the shallow tie soup, all of them)
    assert int(hits.sum()) > int(misses.sum())
    assert int(misses.sum()) > 0 or name == "ties"
    assert int(two.sum()) > 0
    # every return to a row of the path: at most the cache's misses fall
    # back to the table
    assert int(loads.max()) < int(steps.sum(dim=1).max())


@pytest.mark.parametrize("case", ["random", "same_triangle", "t_at_best",
                                  "last_first_row"])
def test_leaf_quad_is_the_sequential_update(case):
    """The leaf step's combine (_leaf_quad: four triangles of two pair rows
    against the old best, the latest accepted of least t) equals four
    sequential _mt_update calls, the plain walk's order, the second row
    skipped where the first is the leaf's last: on random triangles, on
    one triangle four times (ties: the fourth wins), with the old best at
    the first triangle's own t (taken), and with every first row a last
    row (the second row's nearer triangles are not taken)."""
    rs = np.random.RandomState(17)
    n = 4096
    a = rs.uniform(-2, 2, (4, n, 3))
    e1 = rs.uniform(-2, 2, (4, n, 3))
    e2 = rs.uniform(-2, 2, (4, n, 3))
    if case == "same_triangle":
        a[1:], e1[1:], e2[1:] = a[0], e1[0], e2[0]
    org = rs.uniform(-6, 6, (n, 3))
    w = rs.dirichlet([1, 1, 1], n)
    k = np.arange(n) % 4
    aim = (a[k, np.arange(n)] + w[:, 1:2] * e1[k, np.arange(n)]
           + w[:, 2:3] * e2[k, np.arange(n)])
    d = aim - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pair = np.zeros((n, 2, 32), np.float32)
    for j in range(4):
        c = 12 * (j & 1)
        pair[:, j >> 1, c:c + 9] = np.concatenate([a[j], e1[j], e2[j]], 1)
        pair.view(np.int32)[:, j >> 1, c + 9] = j * n + np.arange(n)
    last0 = (rs.rand(n) < 0.3) | (case == "last_first_row")
    pair[:, 0, 10] = np.where(last0, 1.0, 0.0)
    pair[:, 1, 10] = 1.0
    pair = torch.from_numpy(pair)
    org = torch.from_numpy(org.astype(np.float32))
    d = torch.from_numpy(d.astype(np.float32))
    t0 = torch.from_numpy(np.where(rs.rand(n) < 0.5, 1e30, rs.uniform(
        0, 12, n)).astype(np.float32))
    best = (t0, torch.zeros(n), torch.zeros(n),
            torch.full((n,), -7, dtype=torch.int32))
    rows = [pair[:, r] for r in (0, 1)]
    ri = [x.view(torch.int32) for x in rows]
    every = torch.ones(n, dtype=torch.bool)
    if case == "t_at_best":
        first = bw._mt_update(org, d, rows[0], ri[0], 0, best, every)
        best = (first[0],) + best[1:]
    want = best
    for j in range(4):
        want = bw._mt_update(org, d, rows[j >> 1], ri[j >> 1], 12 * (j & 1),
                             want, every if j < 2 else ~torch.from_numpy(
                                 last0))
    got, g0, g1 = bw._leaf_quad(org, d, pair, best)
    assert torch.equal(g0, torch.from_numpy(last0)) and bool(g1.all())
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    won = [(want[3] >= j * n) & (want[3] < (j + 1) * n) for j in range(4)]
    if case == "same_triangle":
        assert int(won[3].sum()) > 100 and not bool(won[0].any())
        assert int(won[1].sum()) > 100  # the first row is the leaf's last
    elif case == "t_at_best":
        assert int((won[0] & (want[0] == best[0])).sum()) > 100
    elif case == "last_first_row":
        assert int((won[0] | won[1]).sum()) > 100
        assert not bool((won[2] | won[3]).any())
    else:
        assert all(int(x.sum()) > 50 for x in won)
