"""Port parity of the raster-grid photon gather: raster3,
build_photon_grid_morton, query_tables, ppm._build_grid_morton_device and
the plain version of gather_flux (what the wrapper runs for CPU tensors) of
pathtracer_tpu_torch against the JAX package's gather_kernel.py and ppm.py,
the gather in interpret mode, on the seeded cases of
tests/test_gather_kernel.py: uniform photons in the unit cube, hits far
outside the grid, hits one cell past the grid's low and high x faces; and
the port's device-built grid against a brute-force sum.

Tolerances: the keys, the grid and the ranges are integer or copied data
and must be equal. The flux is held to rtol 1e-5, atol 1e-7: both sides add
the same photons in the same order (offset, then photon index), but XLA
contracts the distance and weight arithmetic into FMAs. The brute force
(numpy, another order of the sum) is held to the JAX test's rtol 2e-4,
atol 2e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu import ppm as jppm
from pathtracer_tpu.ops.pallas import gather_kernel as jgk
from pathtracer_tpu_torch import ppm
from pathtracer_tpu_torch.ops.cuda import gather_kernel as gk

T = torch.from_numpy
J = jnp.asarray


def _setup(rng, n_hits, n_pho):
    """tests/test_gather_kernel.py's inputs."""
    point = rng.random((n_hits, 3)).astype(np.float32)
    normal = rng.standard_normal((n_hits, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    active = rng.random(n_hits) < 0.9
    pos = rng.random((n_pho, 3)).astype(np.float32)
    nrm = rng.standard_normal((n_pho, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    flux = rng.random((n_pho, 3)).astype(np.float32)
    valid = rng.random(n_pho) < 0.95
    return point, normal, active, pos, nrm, flux, valid


def _case(name):
    """(point, normal, active, pos, nrm, flux, valid, r, lo, cell)."""
    lo = np.zeros(3, np.float32)
    if name == "uniform":
        r = 0.06
        arrays = _setup(np.random.default_rng(0), 1024, 3000)
    elif name == "hit_outside_grid":
        r = 0.05
        point, *rest = _setup(np.random.default_rng(1), 1024, 500)
        point[:512] += 50.0  # far outside the unit-box photon cloud
        arrays = (point, *rest)
    else:
        assert name == "hit_one_cell_past_edge"
        r = 0.05
        pos = np.repeat(np.array([[0.01, 0.5, 0.5], [0.999, 0.5, 0.5]],
                                 np.float32), 4, axis=0)
        nrm = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (8, 1))
        point = np.zeros((1024, 3), np.float32)
        point[:, 1:] = 0.5
        point[0::2, 0] = -0.02  # cell -1 on the low side
        point[1::2, 0] = pos[-1, 0] + 0.02  # one cell past the high side
        normal = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (1024, 1))
        arrays = (point, normal, np.ones(1024, bool), pos, nrm,
                  np.ones((8, 3), np.float32), np.ones(8, bool))
    cell = np.float32(max(r, 1.0 / gk.SIDE))
    return (*arrays, r, lo, cell)


CASES = ["uniform", "hit_outside_grid", "hit_one_cell_past_edge"]


def _brute_force(point, normal, active, pos, nrm, flux, valid, r):
    """O(hits x photons) cone-filter sum (tests/test_gather_kernel.py's)."""
    out = np.zeros((len(point), 3), np.float32)
    for i in np.nonzero(active)[0]:
        d = pos - point[i]
        d2 = (d * d).sum(1)
        ndot = (nrm * normal[i]).sum(1)
        ok = valid & (d2 < r * r) & (ndot > 1e-3)
        w = 1.0 - np.sqrt(d2) / r
        out[i] = (flux[ok] * w[ok, None]).sum(0)
    return out


def test_raster3_equal():
    rng = np.random.default_rng(5)
    c = rng.integers(0, gk.SIDE, (3, 20000)).astype(np.int32)
    c[:, :2] = [[0, gk.SIDE - 1]] * 3
    got = gk.raster3(*(T(x) for x in c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jgk.raster3(*(J(x) for x in c))))


@pytest.mark.parametrize("case", CASES)
def test_grid_and_query_tables_equal(case):
    point, _, active, pos, nrm, flux, valid, r, lo, cell = _case(case)
    tbl, start, count = gk.build_photon_grid_morton(
        T(pos), T(nrm), T(flux), T(valid), T(lo), cell)
    w_tbl, w_start, w_count = (np.asarray(x) for x in
                               jgk.build_photon_grid_morton(
                                   J(pos), J(nrm), J(flux), J(valid), J(lo),
                                   cell))
    assert start.shape == count.shape == (gk.SIDE ** 3,)
    np.testing.assert_array_equal(start.numpy(), w_start)
    np.testing.assert_array_equal(count.numpy(), w_count)
    assert tbl.shape == w_tbl.shape == (16, -(-len(pos) // 128) * 128)
    n_valid = int(valid.sum())  # the valid deposits sort first
    np.testing.assert_array_equal(tbl.numpy()[:, :n_valid],
                                  w_tbl[:, :n_valid])
    assert (tbl.numpy()[:, len(pos):] == gk.BIG).all()  # the pad columns
    assert (tbl.numpy()[9:] == gk.BIG).all()
    s, e, own = gk.query_tables(T(point), T(active), T(lo), cell, start,
                                count)
    w_s, w_e, w_own = (np.asarray(x) for x in jgk.query_tables(
        J(point), J(active), J(lo), cell, J(w_start), J(w_count)))
    assert s.shape == e.shape == (gk.N_OFF, len(point))
    np.testing.assert_array_equal(s.numpy(), w_s)
    np.testing.assert_array_equal(e.numpy(), w_e)
    np.testing.assert_array_equal(own.numpy(), w_own)
    assert (e.numpy() > s.numpy()).any()


@pytest.mark.parametrize("case", CASES)
def test_gather_flux_plain_matches_pallas(case):
    point, normal, active, pos, nrm, flux, valid, r, lo, cell = _case(case)
    w_tbl, w_start, w_count = jgk.build_photon_grid_morton(
        J(pos), J(nrm), J(flux), J(valid), J(lo), cell)
    w_s, w_e, _ = jgk.query_tables(J(point), J(active), J(lo), cell, w_start,
                                   w_count)
    want = np.asarray(jgk.gather_flux_pallas(J(point), J(normal), w_s, w_e,
                                             w_tbl, np.float32(r),
                                             interpret=True))
    got = gk.gather_flux(T(point), T(normal), T(np.array(w_s)),
                         T(np.array(w_e)), T(np.array(w_tbl)), r)
    assert gk.gather_flux.launches == 0  # CPU tensors: plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    assert (got.numpy()[~active] == 0.0).all()
    assert got.numpy().sum() > 0
    if case == "hit_outside_grid":
        assert (got.numpy()[:512] == 0.0).all()


def test_device_grid_build_matches_jax_and_bruteforce():
    """ppm._build_grid_morton_device (origin and cell in float32, no host
    read) equals the JAX build, and its gather equals the brute force."""
    point, normal, active, pos, nrm, flux, valid = _setup(
        np.random.default_rng(3), 1024, 2000)
    r = 0.07
    tbl, start, count, glo, cell = ppm._build_grid_morton_device(
        T(pos), T(nrm), T(flux), T(valid), r)
    w = [np.asarray(x) for x in jppm._build_grid_morton_device(
        J(pos), J(nrm), J(flux), J(valid), jnp.float32(r))]
    np.testing.assert_array_equal(glo.numpy(), w[3])
    assert cell.dtype == torch.float32 and float(cell) == float(w[4])
    np.testing.assert_array_equal(start.numpy(), w[1])
    np.testing.assert_array_equal(count.numpy(), w[2])
    s, e, _ = gk.query_tables(T(point), T(active), glo, cell, start, count)
    got = gk.gather_flux(T(point), T(normal), s, e, tbl, r).numpy()
    want = _brute_force(point, normal, active, pos, nrm, flux, valid, r)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert want.sum() > 0


def test_gather_flux_refuses_other_devices():
    m = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt,
                                                     device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        gk.gather_flux(m(1024, 3), m(1024, 3), m(9, 1024, dt=torch.int32),
                       m(9, 1024, dt=torch.int32), m(16, 128), 0.05)
    assert gk.gather_flux.launches == 0


def test_warp_order_puts_the_longest_groups_first():
    """warp_order is a permutation of the 32-hit groups, sorted by each
    group's longest lane (its pairs over the 9 ranges), descending and
    stable; a range with e < s counts as empty."""
    rng = np.random.default_rng(7)
    s = rng.integers(0, 1000, (gk.N_OFF, 4096)).astype(np.int32)
    e = s + rng.integers(-3, 200, s.shape).astype(np.int32)
    e[:, 64:96] = s[:, 64:96]  # a group of empty ranges
    order = gk.warp_order(T(s), T(e)).numpy()
    assert order.dtype == np.int32
    assert sorted(order.tolist()) == list(range(4096 // 32))
    longest = np.maximum(e - s, 0).sum(axis=0).reshape(-1, 32).max(axis=1)
    np.testing.assert_array_equal(
        order, np.argsort(-longest, kind="stable").astype(np.int32))
    assert order[-1] == 2 and longest[order[0]] == longest.max()


def test_raster_pair_counts_match_a_brute_count():
    """raster_pair_counts (chip_smoke.py's work count for the raster
    gather's bound), in steps of 997 pairs, against a per-hit float32 count
    over each range: all pairs, those with d^2 < r^2, and those of them
    with n . n_p > 1e-3."""
    point, normal, active, pos, nrm, flux, valid = _setup(
        np.random.default_rng(4), 1024, 2000)
    r = 0.07
    tbl, start, count, glo, cell = ppm._build_grid_morton_device(
        T(pos), T(nrm), T(flux), T(valid), r)
    s, e, _ = gk.query_tables(T(point), T(active), glo, cell, start, count)
    got = gk.raster_pair_counts(T(point), T(normal), s, e, tbl, r, step=997)
    p = tbl.numpy()
    r2 = np.float32(r) * np.float32(r)
    want = [0, 0, 0]
    for i in range(len(point)):
        for o in range(gk.N_OFF):
            j = np.arange(int(s[o, i]), int(e[o, i]))
            dx, dy, dz = (p[c, j] - point[i, c] for c in range(3))
            d2 = dx * dx + dy * dy + dz * dz
            ndot = p[3, j] * normal[i, 0] + p[4, j] * normal[i, 1] \
                + p[5, j] * normal[i, 2]
            near = d2 < r2
            want[0] += len(j)
            want[1] += int(near.sum())
            want[2] += int((near & (ndot > np.float32(1e-3))).sum())
    assert list(got) == want
    assert want[0] > want[1] > want[2] > 0
