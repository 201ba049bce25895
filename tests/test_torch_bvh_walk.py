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
