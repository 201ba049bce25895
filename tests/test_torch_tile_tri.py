"""The plain tile-culled triangle kernel of pathtracer_tpu_torch
(intersect_tile_tris_plain, what the wrapper runs for CPU tensors) against
the JAX intersect_tile_tris_pallas in interpret mode, on the same table.

Setup of tests/test_tile_tri.py's kernel test: 600 random triangles in front
of, behind and beside a camera at the origin, 64x64 rays jittered as the
eye pass makes them, the table built by the JAX brute-force cull (the port
builds only the BVH cull; its table equals JAX's, tests/test_torch_mesh.py).
The port reads directions and writes results in raster order; the JAX
kernel's tile-ordered output goes through its `back` lane map.

Tolerances: hit and idx equal on every lane, t to rtol 5e-6, u and v to
atol 5e-5 (test_tile_tri.py's bounds for the same formula in another
expression graph: XLA may contract the products into FMAs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.camera import Camera as JCamera
from pathtracer_tpu.ops.pallas import tile_tri_kernel as jttk
from pathtracer_tpu_torch.ops.cuda import tile_tri_kernel as ttk

W = H = 64


def _random_tris(n, rng):
    a = rng.uniform(-3, 3, (n, 3))
    a[:, 2] = rng.uniform(-6, -1, n)
    a[: n // 8, 2] = rng.uniform(1, 4, n // 8)  # behind the camera
    a[n // 8: n // 4, 0] += 50.0  # far off-frustum
    e1 = rng.uniform(-0.8, 0.8, (n, 3))
    e2 = rng.uniform(-0.8, 0.8, (n, 3))
    return (a.astype(np.float32), e1.astype(np.float32),
            e2.astype(np.float32))


def _setup(dup_first=False):
    """(JAX table, directions (W*H, 3) f32 raster); dup_first lists every
    triangle twice (index i and i + 600), exact ties that only the lower
    index may win."""
    rng = np.random.default_rng(7)
    cam = JCamera.create(eye=(0, 0, 0), target=(0, 0, -1), up=(0, 1, 0),
                         aspect=W / H, vertical_fov_deg=60.0)
    a, e1, e2 = _random_tris(600, rng)
    if dup_first:
        a, e1, e2 = (np.concatenate([x, x]) for x in (a, e1, e2))
    tt = jttk.build_tile_tri_table(cam, a, e1, e2, W, H)
    lanes = W * H
    lane_ids = np.arange(lanes)
    dx = rng.random(lanes).astype(np.float32)
    dy = rng.random(lanes).astype(np.float32)
    cx = ((lane_ids % W) + dx) * np.float32(1.0 / W)
    cy = ((lane_ids // W) + dy) * np.float32(1.0 / H)
    d = np.array(cam.ray_dirs(jnp.asarray(cx), jnp.asarray(cy)))
    return tt, d


def _jax_kernel(tt, d):
    bands, n_tiles = jttk.band_chunk_maps(tt, H)
    src_lane, back = jttk.lane_maps(W, H, tt.tx_n)
    d_rows = jnp.asarray(d[src_lane].T.reshape(
        3, (n_tiles + 1) * jttk.BLOCK_ROWS, jttk.LANES))
    out = jttk.intersect_tile_tris_pallas(
        jnp.asarray(tt.table), *(jnp.asarray(x) for x in bands[0]), d_rows,
        n_tiles, interpret=True)
    return [np.asarray(o).reshape(-1)[back] for o in out]


def _port(tt, d, tiles=None):
    args = (torch.from_numpy(tt.table), torch.from_numpy(tt.tile_chunk_start),
            torch.from_numpy(tt.tile_chunk_src), torch.from_numpy(d), W)
    if tiles is None:
        return [x.numpy() for x in ttk.intersect_tile_tris(*args)]
    return [x.numpy() for x in ttk.intersect_tile_tris_plain(*args,
                                                             tiles=tiles)]


@pytest.mark.parametrize("dup_first", [False, True])
def test_plain_tile_kernel_matches_pallas_interpret(dup_first):
    tt, d = _setup(dup_first)
    jt, ju, jv, ji = _jax_kernel(tt, d)
    t, u, v, idx = _port(tt, d)
    assert idx.dtype == np.int32
    hit, jhit = t < ttk.BIG, jt < float(jttk.BIG)
    np.testing.assert_array_equal(hit, jhit)
    np.testing.assert_array_equal(idx, ji)
    assert 200 < int(hit.sum()) < W * H
    np.testing.assert_allclose(t, jt, rtol=5e-6)
    np.testing.assert_allclose(u, ju, atol=5e-5)
    np.testing.assert_allclose(v, jv, atol=5e-5)
    np.testing.assert_array_equal(u[~hit], 0.0)
    np.testing.assert_array_equal(idx[~hit], 0)
    if dup_first:  # the copies (indices >= 600) never win a tie
        assert int(idx.max()) < 600


def test_plain_tile_subset_and_empty_tiles():
    """A subset of the tiles computes the same lanes as the whole image and
    leaves the others as misses; an empty tile (the shared zero chunk) is a
    miss everywhere."""
    tt, d = _setup()
    full = _port(tt, d)
    tiles = [0, 3, 2]
    part = _port(tt, d, tiles=tiles)
    y, x = np.divmod(np.arange(W * H), W)
    mine = np.isin((y // 32) * tt.tx_n + x // 32, tiles)
    for a, b in zip(full, part):
        np.testing.assert_array_equal(a[mine], b[mine])
    assert (part[0][~mine] == ttk.BIG).all() and (part[3][~mine] == 0).all()
    empty = ttk.TileTriTable(
        table=np.zeros((16, ttk.CHUNK), np.float32),
        tile_chunk_start=np.arange(5, dtype=np.int32),
        tile_chunk_src=np.zeros(4, np.int32), tx_n=2, ty_n=2, width=W,
        height=H)
    t, u, v, idx = _port(empty, d)
    assert (t == ttk.BIG).all() and not u.any() and not v.any() \
        and not idx.any()


def test_tile_wrapper_refuses_malformed_input():
    tt, d = _setup()
    args = [torch.from_numpy(tt.table), torch.from_numpy(tt.tile_chunk_start),
            torch.from_numpy(tt.tile_chunk_src), torch.from_numpy(d)]
    with pytest.raises(ValueError):  # rows not a multiple of 32
        ttk.intersect_tile_tris(*args[:3], args[3][:W * 40], W)
    with pytest.raises(ValueError):  # int64 chunk maps
        ttk.intersect_tile_tris(args[0], args[1].long(), args[2], args[3], W)
