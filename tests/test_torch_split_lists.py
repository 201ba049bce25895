"""The split lists of the chunk gather and the tile-culled triangle kernel
of pathtracer_tpu_torch: their kernels cut long lists into work items of
at most SEG list positions (gather) or of one 256-triangle chunk (tile
kernel), walked on different CTAs and combined in a fixed order. These
tests hold what the CPU can reach: the plain gather's segment-then-combine
order, the tile kernel's chunk -> tile search and its combine rule.

- (tests/test_torch_gather.py holds the segmented plain gather against the
  JAX gather in interpret mode, at SEG as shipped and at SEG = 1.)
- With SEG at or above every list's length, the plain gather equals the
  unsplit order (one running sum per lane) bit for bit.
- The kernel's chunk -> tile search gives each chunk of the CSR to the
  tile whose range holds it, so the items cover each tile's chunks once,
  in CSR order, and an empty tile's one item is the zero chunk.
- intersect_tile_tris_plain run chunk by chunk and combined with the
  strict `t < best` rule equals the unsplit plain version bit for bit,
  ties (every triangle listed twice) included."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.camera import Camera as JCamera
from pathtracer_tpu.ops.pallas import tile_tri_kernel as jttk
from pathtracer_tpu_torch.ops import vec
from pathtracer_tpu_torch.ops.cuda import gather_kernel as gk
from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk

T = torch.from_numpy


def _gather_case(name):
    """Seeded (point, normal, active, pos, nrm, flux, valid, r): the
    uniform and near-outlier cases of tests/test_gather_kernel.py."""
    rng = np.random.default_rng(0 if name == "uniform_with_outliers" else 2)
    n_hits, n_pho = (2048, 3000) if name == "uniform_with_outliers" \
        else (1024, 2000)
    point = rng.random((n_hits, 3)).astype(np.float32)
    normal = rng.standard_normal((n_hits, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    active = rng.random(n_hits) < 0.9
    pos = rng.random((n_pho, 3)).astype(np.float32)
    nrm = rng.standard_normal((n_pho, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    flux = rng.random((n_pho, 3)).astype(np.float32)
    valid = rng.random(n_pho) < 0.95
    if name == "uniform_with_outliers":
        pos[::17] += 40.0
        return point, normal, active, pos, nrm, flux, valid, 0.06
    r = 0.08
    pos[:50] += 40.0
    point[:100] = pos[:50].repeat(2, axis=0) + rng.standard_normal(
        (100, 3)).astype(np.float32) * (r / 4)
    return point, normal, active, pos, nrm, flux, valid, r


GATHER_CASES = ["uniform_with_outliers", "hits_near_outliers"]


def _gather_inputs(name):
    """The port's gather inputs: (point, normal, active, sbox, photons_t,
    r) as tensors."""
    point, normal, active, pos, nrm, flux, valid, r = _gather_case(name)
    tbl, sbox = gk.build_photon_chunks(T(pos), T(nrm), T(flux), T(valid))
    return T(point), T(normal), T(active), sbox, tbl, r


def _unsplit_gather(point, normal, active, sbox, photons_t, radius):
    """The gather's order before the split: one running sum per lane over
    the whole list (list position, then sub-chunk, then photon)."""
    n = point.shape[0]
    nblk = n // gk.BLOCK
    lists, counts = gk.block_chunk_lists(point, active, sbox, radius)
    _, inv_r, r2, _ = gk._radius_f32(radius)
    ndot_min = float(np.float32(1e-3))
    pts = point.reshape(nblk, gk.BLOCK, 3)
    nrms = normal.reshape(nblk, gk.BLOCK, 3)
    acc = torch.zeros(nblk, gk.BLOCK, 3)
    j128 = torch.arange(gk.CHB)
    sub_t = torch.arange(gk.N_SUBS)
    cnt = counts.to(torch.int64)
    x, y, z = (pts[:, :, c, None] for c in range(3))
    nx, ny, nz = (nrms[:, :, c, None] for c in range(3))
    for k in range(int(cnt.max())):
        word = lists[:, k].to(torch.int64) & 0xFFFFFFFF
        ci = word & ((1 << gk.MASK_SHIFT) - 1)
        sub_on = (cnt > k)[:, None] & (((word >> gk.MASK_SHIFT)[:, None]
                                        >> sub_t) & 1).bool()
        ph = photons_t[0:9][:, ci[:, None] * gk.CHB + j128]
        p = [ph[c][:, None, :] for c in range(9)]
        dx, dy, dz = p[0] - x, p[1] - y, p[2] - z
        d2 = dx * dx + dy * dy + dz * dz
        ndot = p[3] * nx + p[4] * ny + p[5] * nz
        ok = (d2 < float(r2)) & (ndot > ndot_min)
        wf = torch.where(ok, 1.0 - vec.sqrt(d2) * float(inv_r), 0.0)
        on = sub_on.repeat_interleave(gk.SUB, dim=1)[:, None, :]
        contrib = torch.stack(
            [torch.where(on, wf * p[6 + c], 0.0) for c in range(3)], -1)
        for j in range(gk.CHB):
            acc = acc + contrib[:, :, j]
    return torch.where(active[:, None], acc.reshape(n, 3), 0.0)


@pytest.mark.parametrize("case", GATHER_CASES)
def test_plain_gather_is_unsplit_when_lists_fit(case, monkeypatch):
    args = _gather_inputs(case)
    _, counts = gk.block_chunk_lists(args[0], args[2], args[3], args[5])
    monkeypatch.setattr(gk, "SEG", int(counts.max()))
    got = gk.gather_flux_chunks_plain(*args)
    assert torch.equal(got, _unsplit_gather(*args))
    assert float(got.sum()) > 0


W = H = 64


@functools.lru_cache(maxsize=None)
def _tile_setup(dup_first):
    """A table as tests/test_torch_tile_tri.py builds it (the JAX
    brute-force cull), over 4,000 random triangles so that tiles hold
    several 256-triangle chunks, or each listed twice (exact ties only the
    lower index may win), and jittered 64x64 primary directions in raster
    order."""
    n = 4000
    rng = np.random.default_rng(7)
    cam = JCamera.create(eye=(0, 0, 0), target=(0, 0, -1), up=(0, 1, 0),
                         aspect=W / H, vertical_fov_deg=60.0)
    a = rng.uniform(-3, 3, (n, 3))
    a[:, 2] = rng.uniform(-6, -1, n)
    a[:n // 8, 2] = rng.uniform(1, 4, n // 8)  # behind the camera
    a[n // 8:n // 4, 0] += 50.0  # far off-frustum
    e1 = rng.uniform(-0.8, 0.8, (n, 3))
    e2 = rng.uniform(-0.8, 0.8, (n, 3))
    tris = [x.astype(np.float32) for x in (a, e1, e2)]
    if dup_first:
        tris = [np.concatenate([x, x]) for x in tris]
    tt = jttk.build_tile_tri_table(cam, *tris, W, H)
    lane = np.arange(W * H)
    cx = ((lane % W) + rng.random(W * H).astype(np.float32)) \
        * np.float32(1.0 / W)
    cy = ((lane // W) + rng.random(W * H).astype(np.float32)) \
        * np.float32(1.0 / H)
    d = np.array(cam.ray_dirs(jnp.asarray(cx), jnp.asarray(cy)))
    return tt, d


def _chunk_tile(start, c):
    """The kernel's search (intersect_tile_tris.cu, chunk_tile): the last
    tile t with start[t] <= c."""
    lo, hi = 0, len(start) - 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if start[mid] <= c:
            lo = mid
        else:
            hi = mid
    return lo


def _tile_csr(name):
    """(tile_chunk_start, tile_chunk_src, zero chunk) of a table, or a
    synthetic CSR with an empty tile (its one zero chunk) between long
    ones."""
    if name == "empty_tile":
        zero = 40
        return (np.array([0, 7, 8, 13, 14], np.int32),
                np.array([0, 1, 2, 3, 4, 5, 6, zero, 7, 8, 9, 10, 11, zero],
                         np.int32), zero)
    tt, _ = _tile_setup(name == "table_with_ties")
    return tt.tile_chunk_start, tt.tile_chunk_src, tt.zero_chunk


@pytest.mark.parametrize("csr", ["table", "table_with_ties", "empty_tile"])
def test_tile_chunks_cover_each_tile_once(csr):
    start, src, zero = _tile_csr(csr)
    n_tiles = len(start) - 1
    tiles = np.array([_chunk_tile(start, c) for c in range(len(src))])
    # each chunk goes to the tile whose range holds it: tile by tile, in
    # CSR order, every chunk once
    np.testing.assert_array_equal(
        tiles, np.repeat(np.arange(n_tiles), np.diff(start)))
    assert np.diff(start).max() > 1  # some tile splits over CTAs
    if csr == "empty_tile":  # its one item is the zero chunk
        assert tiles[7] == 1 and src[7] == zero


def _items_combined(tt, d):
    """intersect_tile_tris_plain over each chunk of each tile (a sub-CSR of
    one chunk per tile), kept per lane where its t is strictly below the
    best so far, chunk by chunk in order."""
    start = tt.tile_chunk_start
    counts = np.diff(start)
    best = None
    for r in range(int(counts.max())):
        # round r: the r-th chunk of every tile that has one; the other
        # tiles get a placeholder chunk and are not computed (misses)
        live = counts > r
        sub_src = np.where(live, tt.tile_chunk_src[
            np.minimum(start[:-1] + r, start[1:] - 1)],
            tt.tile_chunk_src[0]).astype(np.int32)
        sub_start = np.arange(len(start), dtype=np.int32)
        out = ttk.intersect_tile_tris_plain(
            torch.from_numpy(tt.table), torch.from_numpy(sub_start),
            torch.from_numpy(sub_src), torch.from_numpy(d), W,
            tiles=np.flatnonzero(live).tolist())
        if best is None:
            best = [x.clone() for x in out]
            continue
        take = out[0] < best[0]
        best = [torch.where(take, o, b) for o, b in zip(out, best)]
    return best


@pytest.mark.parametrize("dup_first", [False, True])
def test_split_tile_walk_equals_unsplit(dup_first):
    tt, d = _tile_setup(dup_first)
    assert np.diff(tt.tile_chunk_start).max() > 1  # some tile splits
    got = _items_combined(tt, d)
    want = ttk.intersect_tile_tris_plain(
        torch.from_numpy(tt.table), torch.from_numpy(tt.tile_chunk_start),
        torch.from_numpy(tt.tile_chunk_src), torch.from_numpy(d), W)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] < ttk.BIG).sum()) > 200
    if dup_first:  # the copies (indices >= 4,000) never win a tie
        assert int(got[3].max()) < 4000
