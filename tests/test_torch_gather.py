"""Port parity of the photon gather: the Morton keys, the chunk tables, the
per-block chunk lists and the plain chunk gather of pathtracer_tpu_torch
(ops/cuda/gather_kernel.py) against the JAX package's
ops/pallas/gather_kernel.py, the gather in interpret mode, on seeded numpy
inputs (the cases of tests/test_gather_kernel.py: uniform photons, far
outliers, hits next to the outliers, no valid photon). The plain gather
sums each list in segments of SEG positions and then the segments in
order; it is held to Pallas at SEG as shipped and at SEG = 1, where every
list of more than one chunk splits.

Tolerances: the keys, the chunk tables on their valid columns, the sub-chunk
boxes and the lists are integer or copied data and must be equal. The flux
is held to rtol 1e-5, atol 1e-7: both sides add the same photons in the same
order, but XLA contracts the distance and weight arithmetic into FMAs."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.ops.pallas import gather_kernel as jgk
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
    """(point, normal, active, pos, nrm, flux, valid, r) of one case."""
    if name == "uniform_with_outliers":
        rng = np.random.default_rng(0)
        point, normal, active, pos, nrm, flux, valid = _setup(rng, 2048, 3000)
        pos = pos.copy()
        pos[::17] += 40.0  # sparse far outliers stretch the deposit bbox
        return point, normal, active, pos, nrm, flux, valid, 0.06
    if name == "hits_near_outliers":
        rng = np.random.default_rng(2)
        r = 0.08
        point, normal, active, pos, nrm, flux, valid = _setup(rng, 1024, 2000)
        pos = pos.copy()
        pos[:50] += 40.0
        point = point.copy()
        point[:100] = pos[:50].repeat(2, axis=0) + rng.standard_normal(
            (100, 3)).astype(np.float32) * (r / 4)
        return point, normal, active, pos, nrm, flux, valid, r
    assert name == "no_valid_photons"
    rng = np.random.default_rng(4)
    point, normal, active, pos, nrm, flux, _ = _setup(rng, 1024, 500)
    return point, normal, active, pos, nrm, flux, np.zeros(500, bool), 0.06


CASES = ["uniform_with_outliers", "hits_near_outliers", "no_valid_photons"]


def test_morton3_equal():
    rng = np.random.default_rng(5)
    c = rng.integers(0, 1024, (3, 20000)).astype(np.int32)
    c[:, :3] = [[0, 1023, 1023], [0, 1023, 0], [0, 1023, 1023]]
    got = gk.morton3(*(T(x) for x in c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jgk.morton3(*(J(x) for x in c))))


def test_hit_morton_keys_equal():
    """Inactive hits carry far-out coordinates, whose float->int casts
    overflow; the key masks them after the cast, as the JAX code does."""
    rng = np.random.default_rng(6)
    point = rng.uniform(-3, 3, (8192, 3)).astype(np.float32)
    active = rng.random(8192) < 0.7
    point[~active] *= 1e30
    got = gk.hit_morton_keys(T(point), T(active))
    want = jgk.hit_morton_keys(J(point), J(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    none = np.zeros(8192, bool)
    np.testing.assert_array_equal(
        gk.hit_morton_keys(T(point), T(none)).numpy(),
        np.asarray(jgk.hit_morton_keys(J(point), J(none))))


@pytest.mark.parametrize("case", CASES)
def test_build_photon_chunks_equal(case):
    _, _, _, pos, nrm, flux, valid, _ = _case(case)
    tbl, sbox = gk.build_photon_chunks(T(pos), T(nrm), T(flux), T(valid))
    w_tbl, w_sbox = (np.asarray(x) for x in jgk.build_photon_chunks(
        J(pos), J(nrm), J(flux), J(valid)))
    assert tbl.shape == w_tbl.shape and sbox.shape == w_sbox.shape
    cols = w_tbl[0] < 1e38  # the valid deposits, sorted first
    assert cols.sum() == valid.sum()
    np.testing.assert_array_equal(tbl.numpy()[:, cols], w_tbl[:, cols])
    np.testing.assert_array_equal(sbox.numpy(), w_sbox)


@pytest.mark.parametrize("case", CASES)
def test_block_chunk_lists_equal(case):
    point, _, active, pos, nrm, flux, valid, r = _case(case)
    _, sbox = jgk.build_photon_chunks(J(pos), J(nrm), J(flux), J(valid))
    key = np.asarray(jgk.hit_morton_keys(J(point), J(active)))
    perm = np.argsort(key, kind="stable")
    point, active = point[perm], active[perm]
    lists, counts = gk.block_chunk_lists(T(point), T(active),
                                         T(np.array(sbox)), r)
    w_lists, w_counts = jgk.block_chunk_lists(J(point), J(active), sbox,
                                              np.float32(r))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(w_counts))
    np.testing.assert_array_equal(lists.numpy(), np.asarray(w_lists))
    if case != "no_valid_photons":
        assert counts.numpy().max() > 0


@functools.lru_cache(maxsize=None)
def _pallas_gather(case):
    """The JAX gather of one case, in interpret mode."""
    point, normal, active, pos, nrm, flux, valid, r = _case(case)
    w_tbl, w_sbox = jgk.build_photon_chunks(J(pos), J(nrm), J(flux),
                                            J(valid))
    return np.asarray(jgk.gather_flux_chunks_pallas(
        J(point), J(normal), J(active), w_sbox, w_tbl, np.float32(r),
        interpret=True))


def _check_plain_gather(case):
    point, normal, active, pos, nrm, flux, valid, r = _case(case)
    tbl, sbox = gk.build_photon_chunks(T(pos), T(nrm), T(flux), T(valid))
    got = gk.gather_flux_chunks(T(point), T(normal), T(active), sbox, tbl, r)
    np.testing.assert_allclose(got.numpy(), _pallas_gather(case), rtol=1e-5,
                               atol=1e-7)
    assert (got.numpy()[~active] == 0.0).all()
    if case == "no_valid_photons":
        assert (got.numpy() == 0.0).all()
    else:
        assert got.numpy().sum() > 0
    perm = np.argsort(np.asarray(jgk.hit_morton_keys(J(point), J(active))),
                      kind="stable")
    _, counts = gk.block_chunk_lists(T(point[perm]), T(active[perm]), sbox, r)
    return counts


@pytest.mark.parametrize("case", CASES)
def test_gather_plain_matches_pallas(case):
    counts = _check_plain_gather(case)
    if case == "uniform_with_outliers":  # a list splits at the shipped SEG
        assert int(counts.max()) > gk.SEG


@pytest.mark.parametrize("case", CASES)
def test_gather_plain_split_per_position_matches_pallas(case, monkeypatch):
    """SEG = 1: every list position is a segment of its own."""
    monkeypatch.setattr(gk, "SEG", 1)
    counts = _check_plain_gather(case)
    assert int(gk.block_items(counts)[-1]) == int(counts.sum())
    if case != "no_valid_photons":
        assert int(counts.max()) > 1


def test_gather_wrapper_refuses_other_devices():
    point, normal, active, pos, nrm, flux, valid, r = _case(
        "hits_near_outliers")
    tbl, sbox = gk.build_photon_chunks(T(pos), T(nrm), T(flux), T(valid))
    m = lambda x: x.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        gk.gather_flux_chunks(m(T(point)), m(T(normal)), m(T(active)),
                              m(sbox), m(tbl), r)
