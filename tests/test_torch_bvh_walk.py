"""The plain BVH8 walk of pathtracer_tpu_torch (bvh8_walk_plain, what the
wrapper runs for CPU tensors) against the JAX MeshBVH.intersect (its XLA
walk), both over the same walk table: the JAX MeshBVH carried across with
MeshBVH.from_numpy.

Inputs: the 1,111 random rays of tests/test_ply_bvh.py's multipass test
(origins in [-8, 8]^3, t_max0 3 or 1e30, a quarter inactive) and 64 rays
with exact-zero direction components, half of them starting on the root
box's low plane of a zeroed axis, where (q - po) * (1/d) = 0 * inf is NaN
and must make the box miss.

Tolerances: hit and idx equal on every lane; t to rtol 5e-6 plus atol
1e-6, u and v to atol 5e-5. XLA on the CPU may contract the cross products
of the Moller-Trumbore test into FMAs and sums its dot products in its own
order, and torch does neither, so t, u and v differ in the last bits of
tvec = org - a: an ulp of a coordinate of magnitude 8 is 9.5e-7, and that
absolute difference survives into t however small t is (measured: 14 of
1,175 lanes beyond rtol 5e-6 alone, at most 4.7e-7 absolute). The slab
tests take no products that XLA could contract, and hit and idx agree."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.ops.bvh import MeshBVH as JMeshBVH
from pathtracer_tpu_torch.ops.bvh import MeshBVH
from pathtracer_tpu_torch.ops.cuda import bvh_walk_kernel as bw

CPU = torch.device("cpu")


def _mesh(n=150, seed=5):
    """tests/test_ply_bvh.py's random triangle soup."""
    rs = np.random.RandomState(seed)
    verts = rs.uniform(-5, 5, (n, 3))
    faces = rs.randint(0, n, (2 * n, 3))
    faces = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                  & (faces[:, 0] != faces[:, 2])]
    return verts, faces


@pytest.fixture(scope="module")
def meshes():
    verts, faces = _mesh()
    jm = JMeshBVH(verts, faces, np.zeros(12, np.float32), walk="bvh8")
    m = MeshBVH.from_numpy(dict(
        nodes_lo=jm.nodes_lo, nodes_hi=jm.nodes_hi, meta_np=jm.meta_np,
        tri_a=jm.tri_a, tri_e1=jm.tri_e1, tri_e2=jm.tri_e2,
        mat_row=jm.mat_row, table=jm._table_np, node_end=jm.node_end,
        stride=jm.stride, depth=jm.depth, watertight=False), CPU)
    return jm, m


def _rays(root_lo):
    rs = np.random.RandomState(7)
    n = 1111
    org = rs.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    t_max = np.where(rs.rand(n) < 0.5, 3.0, 1e30).astype(np.float32)
    active = rs.rand(n) > 0.25
    # 64 rays with exact-zero direction components
    rz = np.random.RandomState(11)
    o2 = rz.uniform(-6, 6, (64, 3)).astype(np.float32)
    d2 = rz.randn(64, 3).astype(np.float32)
    for i in range(64):
        axes = [i % 3] if i % 2 else [i % 3, (i + 1) % 3]
        d2[i, axes] = 0.0
        if i >= 32:  # on the root box's low plane of a zeroed axis
            o2[i, axes[0]] = root_lo[axes[0]]
    org = np.concatenate([org, o2])
    d = np.concatenate([d, d2])
    t_max = np.concatenate([t_max, np.full(64, 1e30, np.float32)])
    active = np.concatenate([active, np.ones(64, bool)])
    return org, d, t_max, active


def test_plain_walk_matches_jax_walk(meshes):
    jm, m = meshes
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


def test_plain_walk_lanes_are_independent(meshes):
    """A subset of the lanes walks to the same results as the whole set
    (what the card's check of the kernel on a few blocks relies on), and
    the step counts are those of finished walks."""
    _, m = meshes
    org, d, t_max, active = (torch.from_numpy(x) for x in _rays(m.bbox_lo))
    full = bw.bvh8_walk_plain(m.table, org, d, t_max, active, m.node_end,
                              m.stride, count_steps=True)
    sub = slice(5, None, 3)
    part = bw.bvh8_walk_plain(m.table, org[sub], d[sub], t_max[sub],
                              active[sub], m.node_end, m.stride,
                              check_every=1)
    for a, b in zip(full[:5], part):
        assert torch.equal(a[sub], b)
    steps, visited = full[5:]
    assert int(steps[~active].max()) == 0
    assert int(steps[active, 0].min()) >= 1  # every walk enters its root
    # every hit lane met its winner in a triangle-pair row
    assert bool((steps[full[4], 1] >= 1).all())
    assert 0 < int(visited.sum()) <= m.table.shape[0] - 1


def test_walk_wrapper_refuses_malformed_input(meshes):
    _, m = meshes
    org = torch.zeros(8, 3)
    with pytest.raises(ValueError):  # t_max0 of the wrong length
        bw.bvh8_walk(m.table, org, org, torch.zeros(7), torch.ones(8, dtype=bool),
                     m.node_end, m.stride)
    with pytest.raises(ValueError):  # active is not bool
        bw.bvh8_walk(m.table, org, org, torch.zeros(8), torch.ones(8),
                     m.node_end, m.stride)


def _two_lane_combine(org, d, rows, rows_i, best):
    """The triangle-pair step of csrc/bvh8_walk.cu: lanes 0 and 1 test the
    two triangles against the old best at once, and the second wins iff it
    accepts and (the first does not, or tt2 <= tt1); else the first wins
    iff it accepts. A best index of -1 marks a test that did not accept."""
    is_tri = torch.ones(org.shape[0], dtype=torch.bool)
    unset = best[:3] + (torch.full_like(best[3], -1),)
    one = bw._mt_update(org, d, rows, rows_i, 0, unset, is_tri)
    two = bw._mt_update(org, d, rows, rows_i, 12, unset, is_tri)
    ok1, ok2 = one[3] != -1, two[3] != -1
    second = ok2 & (~ok1 | (two[0] <= one[0]))
    return tuple(torch.where(second, y, torch.where(ok1, x, b))
                 for b, x, y in zip(best, one, two))


@pytest.mark.parametrize("case", ["random", "same_triangle", "t_at_best"])
def test_two_lane_triangle_combine_is_the_sequential_update(case):
    """The combine equals two sequential _mt_update calls (the plain walk's
    order): on random pairs, on pairs of one triangle twice (tt1 == tt2:
    the second wins, as t <= best takes it), and with the old best set to
    the first triangle's own t (tt == best: taken)."""
    rs = np.random.RandomState(17)
    n = 4096
    a = rs.uniform(-2, 2, (2, n, 3))
    e1 = rs.uniform(-2, 2, (2, n, 3))
    e2 = rs.uniform(-2, 2, (2, n, 3))
    if case == "same_triangle":
        a[1], e1[1], e2[1] = a[0], e1[0], e2[0]
    # rays from a box aimed at a point of either triangle
    org = rs.uniform(-6, 6, (n, 3))
    w = rs.dirichlet([1, 1, 1], n)
    k = (np.arange(n) % 2)[:, None, None]
    ak, e1k, e2k = (np.where(k[:, 0], x[1], x[0]) for x in (a, e1, e2))
    aim = ak + w[:, 1:2] * e1k + w[:, 2:3] * e2k
    d = aim - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rows = np.zeros((n, 32), np.float32)
    rows[:, 0:9] = np.concatenate([a[0], e1[0], e2[0]], axis=1)
    rows[:, 12:21] = np.concatenate([a[1], e1[1], e2[1]], axis=1)
    rows_i = rows.view(np.int32)
    rows_i[:, 9] = np.arange(n)
    rows_i[:, 21] = n + np.arange(n)
    rows, rows_i = torch.from_numpy(rows), torch.from_numpy(rows_i.copy())
    org = torch.from_numpy(org.astype(np.float32))
    d = torch.from_numpy(d.astype(np.float32))
    t0 = torch.from_numpy(np.where(rs.rand(n) < 0.5, 1e30, rs.uniform(
        0, 12, n)).astype(np.float32))
    best = (t0, torch.zeros(n), torch.zeros(n),
            torch.full((n,), -7, dtype=torch.int32))
    is_tri = torch.ones(n, dtype=torch.bool)
    if case == "t_at_best":
        first = bw._mt_update(org, d, rows, rows_i, 0, best, is_tri)
        best = (first[0],) + best[1:]  # the first's own t where it hit
    want = bw._mt_update(org, d, rows, rows_i, 12,
                         bw._mt_update(org, d, rows, rows_i, 0, best,
                                       is_tri), is_tri)
    got = _two_lane_combine(org, d, rows, rows_i, best)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    won_first = (want[3] >= 0) & (want[3] < n)
    won_second = want[3] >= n
    if case == "same_triangle":
        assert int(won_second.sum()) > 100 and not bool(won_first.any())
    elif case == "t_at_best":
        assert int((won_first & (want[0] == best[0])).sum()) > 100
    else:
        assert int(won_first.sum()) > 100 and int(won_second.sum()) > 100
