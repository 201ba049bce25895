"""Port parity of the clustered nearest-sphere search: pack_spheres_clustered
and the plain version of intersect_clustered (what the wrapper runs for CPU
tensors) against the JAX package's pack_spheres_clustered and
intersect_clustered_pallas in interpret mode, on the shirley scene (531
spheres in 178 clusters) and 2,048 seeded rays; and native.bvh_build, whose
new length_cutoff / num_bins parameters build the clustered tree, against
the JAX package's copy of the same C++ BVH build.

Tolerances: the tables are host numpy in both packages, from the same C++
tree, and must be equal bit for bit. The rays: idx and hit equal, the a*t
key within rtol 1e-6 plus atol 5e-3. XLA contracts FMAs in the key of the
interpreted kernel, and the key of a ray grazing a sphere far from the
origin is ill-conditioned (|c| ~ 20: g = A + 2 c.o - |o|^2 and
disc = g + bp^2 / a cancel ~4 digits, and the square root magnifies the
rest). Measured: up to 2.7e-3 on 13 of the 4,096 live lanes of the origin
and offset cases, all grazing r=0.2 spheres. The renderer only selects with
the key (idx and hit are exact here). Against the port's
own intersect_spheres plain version, which has the same sphere math and no
cull, hit and at are equal on every live lane: the cull only skips clusters
that no live lane of the block can hit."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.models import shirley as jshirley
from pathtracer_tpu.native import bvh_build_native
from pathtracer_tpu.ops.pallas import sphere_kernel as jsk
from pathtracer_tpu_torch import native
from pathtracer_tpu_torch.io import ply
from pathtracer_tpu_torch.models import shirley
from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk

CPU = torch.device("cpu")
TEST_PLY = os.path.join(os.path.dirname(__file__), "..", "scenes",
                        "test_ganesha.ply")
N = 2048
DEAD = slice(1024, 2048)  # the second block, all dead, in one case


@pytest.fixture(scope="module")
def scenes():
    jscene, jcam, _ = jshirley.build(2.0)
    scene, cam, _ = shirley.build(2.0, CPU)
    return dict(
        jscene=jscene, scene=scene, cam=cam,
        tables=sk.pack_spheres_clustered(scene.center, scene.radius,
                                         scene.valid),
        jtables=jsk.pack_spheres_clustered(np.asarray(jscene.center),
                                           np.asarray(jscene.radius),
                                           np.asarray(jscene.valid)))


def test_clustered_tables_equal_jax(scenes):
    sph, clus, perm = scenes["tables"]
    jsph, jclus, jperm = (np.asarray(x) for x in scenes["jtables"])
    bits = lambda x: np.asarray(x, np.float32).view(np.uint32)
    assert clus.shape == (4, 178) and sph.shape == (4, 178 * sk.CLUSTER)
    np.testing.assert_array_equal(bits(sph.numpy()), bits(jsph))
    np.testing.assert_array_equal(bits(clus.numpy()), bits(jclus))
    np.testing.assert_array_equal(perm.numpy(), jperm)
    # every valid sphere sits in exactly one slot
    valid = np.nonzero(scenes["scene"].valid.numpy())[0]
    real = sph[3].numpy() > -sk.BIG
    np.testing.assert_array_equal(np.sort(perm.numpy()[real]), valid)


def _rays(scene, cam, kind, seed):
    """(org, d, alive) numpy: camera rays from the origin, or rays leaving
    points near random spheres in random directions."""
    rng = np.random.default_rng(seed)
    if kind == "origin":
        cx = rng.random(N).astype(np.float32)
        cy = rng.random(N).astype(np.float32)
        d = cam.ray_dirs(torch.from_numpy(cx), torch.from_numpy(cy)).numpy()
        org = np.zeros_like(d)
    else:
        c = scene.center.numpy().astype(np.float64)
        r = scene.radius.numpy().astype(np.float64)
        s = rng.choice(np.nonzero(scene.valid.numpy())[0], N)
        u = rng.standard_normal((N, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        org = c[s] + u * (r[s] + rng.uniform(0.01, 2.0, N))[:, None]
        d = rng.standard_normal((N, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = rng.random(N) < 0.85
    if kind == "offset_dead_block":
        alive[DEAD] = False
    return org.astype(np.float32), d.astype(np.float32), alive


@pytest.mark.parametrize("kind", ["origin", "offset", "offset_dead_block"])
def test_intersect_clustered_plain_matches_pallas(scenes, kind):
    org, d, alive = _rays(scenes["scene"], scenes["cam"], kind, 7)
    args = (torch.from_numpy(org), torch.from_numpy(d),
            torch.from_numpy(alive))
    at, idx, hit, inv_a = sk.intersect_clustered(scenes["tables"], *args)
    assert sk.intersect_clustered.launches == 0  # CPU: the plain version
    w_at, w_idx, w_hit, w_inv = (np.asarray(x) for x in
                                 jsk.intersect_clustered_pallas(
                                     scenes["jtables"], jnp.asarray(org),
                                     jnp.asarray(d), jnp.asarray(alive),
                                     interpret=True))
    np.testing.assert_array_equal(idx.numpy(), w_idx)
    np.testing.assert_array_equal(hit.numpy(), w_hit)
    np.testing.assert_allclose(at.numpy(), w_at, rtol=1e-6, atol=5e-3)
    np.testing.assert_allclose(inv_a.numpy(), w_inv, rtol=1e-6)
    assert 0.1 < hit.numpy()[alive].mean() < 1.0
    if kind == "offset_dead_block":  # an all-dead block is all miss
        assert not hit[DEAD].any() and (at[DEAD] == sk.BIG).all()
    # the yardstick: the same hits as the brute force over all spheres
    table = sk.pack_spheres(scenes["scene"].center, scenes["scene"].radius,
                            scenes["scene"].valid)
    b_at, b_idx, b_hit, _ = sk.intersect_spheres_plain(table, *args)
    live = args[2]
    assert torch.equal(hit[live], b_hit[live])
    assert torch.equal(at[live], b_at[live])


def test_intersect_clustered_refuses_other_devices(scenes):
    meta = torch.zeros(1024, 3, device="meta")
    alive = torch.ones(1024, dtype=torch.bool, device="meta")
    tables = tuple(t.to("meta") for t in scenes["tables"])
    with pytest.raises(ValueError, match="no kernel"):
        sk.intersect_clustered(tables, meta, meta, alive)
    assert sk.intersect_clustered.launches == 0


def test_bvh_build_defaults_unchanged():
    """The mesh build at the defaults, and the clustered build's settings,
    give the JAX package's native build byte for byte (the same C++
    source), on scenes/test_ganesha.ply's triangle boxes."""
    mesh = ply.load(TEST_PLY)
    verts = np.stack([mesh.data["vertex"][k] for k in "xyz"], 1)
    faces = np.asarray(mesh.data["vertex_indices"]["vertex_indices"])
    tri = verts[faces].astype(np.float32)
    lo, hi = tri.min(axis=1), tri.max(axis=1)
    for kw, jkw in (({}, dict(length_cutoff=8, num_bins=32)),
                    (dict(length_cutoff=16, num_bins=16),
                     dict(length_cutoff=16, num_bins=16))):
        got = native.bvh_build(lo, hi, **kw)
        want = bvh_build_native(lo, hi, want_axes=True, **jkw)
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            if isinstance(g, np.ndarray):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
            else:
                assert g == w
    assert native.LENGTH_CUTOFF == 8 and native.NUM_BINS == 32
