"""Port parity of the photon mapper's nearest-hit searches: the plain
versions of intersect_spheres and intersect_tris (what the wrappers run for
CPU tensors) against the JAX package's intersect_spheres_pallas and
intersect_tris_pallas in interpret mode, on the cornell tables and 4,096
seeded rays: camera primaries, rays from inside the box, rays grazing each
sphere (1e-3 of the radius inside or outside it) and each triangle's edges
(barycentrics 1e-4 from an edge), rays nearly parallel to a triangle, one
all-dead 1024-ray block, and a duplicated triangle for the tie-break.

Tolerances: idx and hit exact (the rays stay clear of the f32-ambiguous
boundaries, so no selection flips); t and 1/a rtol 1e-6. The sphere key
a*t: rtol 1e-6 plus atol 5e-4. XLA contracts FMAs in the interpreted
kernel body, and the key is ill-conditioned for grazing rays (disc = g +
bp^2/a cancels) and for rays that start near a sphere (bp = c.d - o.d and
a*t = bp -/+ sqrt cancel): measured up to 2.5e-4 apart on these rays
(relative 1.6e-4), 2.5e-6 relative on the camera primaries. The renderer
uses the key only to select (idx, hit, exact here) and recomputes t per
ray with stable_t."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.models import cornell as jcornell
from pathtracer_tpu.ops.pallas import sphere_kernel as jsk
from pathtracer_tpu.ops.pallas import tri_kernel as jtk
from pathtracer_tpu.scene import TRI_A as JA, TRI_E1 as JE1, TRI_E2 as JE2
from pathtracer_tpu_torch.models import cornell
from pathtracer_tpu_torch.ops.cuda import sphere_kernel as sk
from pathtracer_tpu_torch.ops.cuda import tri_kernel as tk
from pathtracer_tpu_torch.scene import TRI_A, TRI_E1, TRI_E2

CPU = torch.device("cpu")
N = 4096
DEAD = slice(1024, 2048)  # one block with no live ray


@pytest.fixture(scope="module")
def tables():
    jscene, _, _ = jcornell.build(1.0)
    scene, _, _ = cornell.build(1.0, CPU)
    tp = scene.tri_pack
    jtp = jscene.tri_pack
    return dict(
        sph=sk.pack_spheres(scene.center, scene.radius, scene.valid),
        jsph=jsk.pack_spheres_pallas(jscene.center, jscene.radius,
                                     jscene.valid),
        tri=tk.pack_tris(tp[:, TRI_A], tp[:, TRI_E1], tp[:, TRI_E2],
                         scene.tri_valid),
        jtri=jtk.pack_tris_pallas(jtp[:, JA], jtp[:, JE1], jtp[:, JE2],
                                  jscene.tri_valid),
        scene=scene)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _rays(scene, seed):
    """(org, d, alive) f32/bool numpy arrays of N rays."""
    rng = np.random.default_rng(seed)
    q = N // 8
    org = np.zeros((N, 3))
    d = rng.standard_normal((N, 3))
    d[:q, 2] = -np.abs(d[:q, 2]) - 1.0  # camera primaries, origin 0
    # from inside the box (camera space: x, y in [-0.5, 0.5], z in [-2, -1])
    org[q:4 * q] = rng.uniform([-0.5, -0.5, -2.0], [0.5, 0.5, -1.0],
                               (3 * q, 3))
    d[q:4 * q] *= rng.uniform(0.3, 3.0, (3 * q, 1))  # any |d|
    # grazing the spheres
    c = scene.center.numpy().astype(np.float64)
    r = scene.radius.numpy().astype(np.float64)
    valid = np.nonzero(scene.valid.numpy())[0]
    i = np.arange(4 * q, 6 * q)
    s = valid[i % len(valid)]
    dd = _unit(rng.standard_normal((len(i), 3)))
    p = _unit(np.cross(dd, rng.standard_normal((len(i), 3))))
    rad = r[s] * np.where(i % 2 == 0, 1.0 - 1e-3, 1.0 + 1e-3)
    org[i] = c[s] + rad[:, None] * p - 2.5 * dd
    d[i] = dd
    # grazing the triangles' edges, and nearly parallel to them
    tp = scene.tri_pack.numpy().astype(np.float64)
    tv = np.nonzero(scene.tri_valid.numpy())[0]
    i = np.arange(6 * q, N)
    t = tv[i % len(tv)]
    u = rng.uniform(0.1, 0.9, len(i))
    edge = i % 3
    eps = np.where(i % 2 == 0, 1e-4, -1e-4)
    bu = np.where(edge == 0, eps, np.where(edge == 1, u, u))
    bv = np.where(edge == 0, u, np.where(edge == 1, eps, 1.0 - u - eps))
    target = tp[t, 0:3] + bu[:, None] * tp[t, 3:6] + bv[:, None] * tp[t, 6:9]
    nrm = _unit(np.cross(tp[t, 3:6], tp[t, 6:9]))
    tilt = np.where((i % 5 == 0)[:, None], 0.02, 1.0)  # nearly parallel
    side = _unit(rng.standard_normal((len(i), 3)))
    side -= (side * nrm).sum(1, keepdims=True) * nrm
    off = _unit(nrm * tilt + _unit(side)) * rng.uniform(0.2, 1.0,
                                                        (len(i), 1))
    org[i] = target + off
    d[i] = -off
    alive = rng.random(N) < 0.85
    alive[DEAD] = False
    return (org.astype(np.float32), d.astype(np.float32), alive)


def test_cornell_tables_bit_equal(tables):
    bits = lambda x: np.asarray(x, np.float32).view(np.uint32)
    assert tables["sph"].shape == (4, 8) and tables["tri"].shape == (9, 128)
    np.testing.assert_array_equal(bits(tables["sph"].numpy()),
                                  bits(tables["jsph"]))
    np.testing.assert_array_equal(bits(tables["tri"].numpy()),
                                  bits(tables["jtri"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_intersect_spheres_plain_matches_pallas(tables, seed):
    org, d, alive = _rays(tables["scene"], seed)
    at, idx, hit, inv_a = sk.intersect_spheres(
        tables["sph"], torch.from_numpy(org), torch.from_numpy(d),
        torch.from_numpy(alive))
    w_at, w_idx, w_hit, w_inv = (np.asarray(x) for x in
                                 jsk.intersect_spheres_pallas(
                                     tables["jsph"], jnp.asarray(org),
                                     jnp.asarray(d), jnp.asarray(alive),
                                     interpret=True))
    np.testing.assert_array_equal(idx.numpy(), w_idx)
    np.testing.assert_array_equal(hit.numpy(), w_hit)
    np.testing.assert_allclose(at.numpy(), w_at, rtol=1e-6, atol=5e-4)
    np.testing.assert_allclose(inv_a.numpy(), w_inv, rtol=1e-6)
    assert not hit[DEAD].any() and (at[DEAD] == sk.BIG).all()
    assert 0.2 < hit.numpy().mean() < 1.0
    # both sides of the grazing radius are exercised
    g = slice(N // 2, 3 * N // 4)
    assert 0.2 < hit.numpy()[g].mean() < 0.95


@pytest.mark.parametrize("seed", [0, 1])
def test_intersect_tris_plain_matches_pallas(tables, seed):
    org, d, alive = _rays(tables["scene"], seed)
    t, idx, hit = tk.intersect_tris(tables["tri"], torch.from_numpy(org),
                                    torch.from_numpy(d),
                                    torch.from_numpy(alive))
    w_t, w_idx, w_hit = (np.asarray(x) for x in jtk.intersect_tris_pallas(
        tables["jtri"], jnp.asarray(org), jnp.asarray(d), jnp.asarray(alive),
        interpret=True))
    np.testing.assert_array_equal(idx.numpy(), w_idx)
    np.testing.assert_array_equal(hit.numpy(), w_hit)
    np.testing.assert_allclose(t.numpy(), w_t, rtol=1e-6)
    assert not hit[DEAD].any() and (t[DEAD] == sk.BIG).all()
    assert 0.5 < hit.numpy().mean() < 1.0


def test_intersect_tris_ties_go_to_the_lowest_index(tables):
    """A copy of triangle 10 in padding slot 20: every ray that hits it
    finds the same t twice and keeps index 10."""
    org, d, alive = _rays(tables["scene"], 2)
    tab = tables["tri"].clone()
    tab[:, 20] = tab[:, 10]
    jtab = np.asarray(tables["jtri"]).copy()
    jtab[:, 20] = jtab[:, 10]
    t, idx, hit = tk.intersect_tris(tab, torch.from_numpy(org),
                                    torch.from_numpy(d),
                                    torch.from_numpy(alive))
    w_t, w_idx, _ = jtk.intersect_tris_pallas(
        jnp.asarray(jtab), jnp.asarray(org), jnp.asarray(d),
        jnp.asarray(alive), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
    assert (idx == 10).sum() > 10 and not (idx == 20).any()


def test_wrappers_refuse_other_devices(tables):
    meta = torch.zeros(1024, 3, device="meta")
    alive = torch.ones(1024, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sk.intersect_spheres(tables["sph"].to("meta"), meta, meta, alive)
    with pytest.raises(ValueError, match="no kernel"):
        tk.intersect_tris(tables["tri"].to("meta"), meta, meta, alive)


@pytest.mark.parametrize("seed", [0, 1])
def test_scattered_pads_match_pallas(seed):
    """The scattered-pad table of tests/test_torch_tri_pads.py (T = 45, real
    columns among pads, inf and NaN rays, origins on a triangle's plane,
    ties): the plain version over the whole table and the plain walk over
    the real columns alone both equal the JAX kernel (T padded to 48 with
    zero columns, as pack_tris_pallas pads), at the tolerances above."""
    from test_torch_tri_pads import real_only, scattered_case
    table, org, d, alive = scattered_case(seed)
    w_t, w_idx, w_hit = (np.asarray(x) for x in jtk.intersect_tris_pallas(
        jnp.asarray(np.pad(table, ((0, 0), (0, 3)))), jnp.asarray(org),
        jnp.asarray(d), jnp.asarray(alive), interpret=True))
    args = tuple(torch.from_numpy(x) for x in (table, org, d, alive))
    for t, idx, hit in (tk.intersect_tris_plain(*args), real_only(*args)):
        np.testing.assert_array_equal(idx.numpy(), w_idx)
        np.testing.assert_array_equal(hit.numpy(), w_hit)
        np.testing.assert_allclose(t.numpy(), w_t, rtol=1e-6)
    assert w_hit.mean() > 0.3
