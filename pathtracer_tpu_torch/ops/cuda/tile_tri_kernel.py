"""Per-tile frustum-culled triangle lists for primary rays (the ganesha eye
pass, and bounce 0 of the path-traced ganesha): the host-side table build
and the nearest-hit kernel.

Port of pathtracer_tpu/ops/pallas/tile_tri_kernel.py: TileTriTable,
build_tile_tri_table (the BVH-guided cull and the back-face cull, in
either film map (flip_y); the brute-force sgemm cull is not ported, so a
MeshBVH is required), band_chunk_maps as band_tile_maps, lane_maps,
and intersect_tile_tris_pallas as `intersect_tile_tris`, which launches
csrc/intersect_tile_tris.cu for CUDA tensors and runs
`intersect_tile_tris_plain` for CPU tensors.
`intersect_band` gives its hits in integrator.Intersector's mesh_intersect
contract, for both renderers.

Primary rays start at the camera-space origin, so a 32x32 image tile's rays
lie inside the cone of its 4 corner directions and a conservative per-tile
list of triangles is built once on the host. The kernel tests each ray
against its tile's list, origin-zero Moller-Trumbore: |det| >= 1e-6,
0 <= u <= 1, v >= 0, u + v <= 1, t >= 0, and a strict `t < best` over
ascending triangle indices, so ties go to the lowest index.

Table layout (16, R) f32: rows 0-2 a, 3-5 e1, 6-8 e2, 9 the triangle index
as an exact f32, 10-15 zero. Each tile's list is padded with all-zero
columns (det = 0, never hit) to a multiple of CHUNK = 256; one shared
all-zero chunk at the end serves empty tiles. tile_chunk_start (n_tiles+1,)
is the CSR over chunks and tile_chunk_src the column block of each chunk.
The kernel reads directions and writes results in raster lane order
(lane = y * width + x) over ty_n*32 rows, so the lane permutations of the
JAX eye pass (src_lane, back) are not needed around it.

The kernel walks each chunk of a tile's range on CTAs of its own and
keeps, per ray, the first chunk's best whose t is strictly the least: the
same first minimum as one strict-< walk over the whole list, so the plain
version walks the list unsplit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import _build, native
from ..frustum import tile_frustum_planes
from .sphere_kernel import BIG

__all__ = ["TILE", "CHUNK", "TileTriTable", "build_tile_tri_table",
           "band_tile_maps", "lane_maps", "intersect_tile_tris",
           "intersect_tile_tris_plain", "intersect_band"]

_EPS = float(np.float32(1e-6))
TILE = 32
# triangles per chunk: one shared-memory stage and one work item of the
# kernel
CHUNK = 256
_ROWS = 10  # table rows the kernel reads: a, e1, e2, index


@dataclass
class TileTriTable:
    """Whole-image per-tile culled triangle lists in flat chunk layout."""

    table: np.ndarray  # (16, R) f32; the last CHUNK columns are the zero chunk
    tile_chunk_start: np.ndarray  # (n_tiles+1,) int32 CSR over chunks
    tile_chunk_src: np.ndarray  # (total_chunks,) int32 column block per chunk
    tx_n: int
    ty_n: int
    width: int
    height: int

    @property
    def zero_chunk(self) -> int:
        return self.table.shape[1] // CHUNK - 1

    def tensors(self, device):
        """(table, tile_chunk_start, tile_chunk_src) as tensors on device."""
        return tuple(torch.as_tensor(np.ascontiguousarray(x), device=device)
                     for x in (self.table, self.tile_chunk_start,
                               self.tile_chunk_src))


def _tile_corner_dirs(camera, width, height, tx_n, ty_n, flip_y=False):
    """(T, 4, 3) f64 corner directions per tile in the consumer's film map:
    the PPM eye pass's cy = y/H (flip_y False) or the path tracer's
    cy = 1 - y/H (flip_y True), as tile_frustum_planes. A tile's rays are
    exactly the conical hull of these 4 directions."""
    xs = np.arange(tx_n + 1) * (TILE / width)
    ys = np.arange(ty_n + 1) * (TILE / height)
    if flip_y:
        ys = 1.0 - ys
    cx = np.broadcast_to(xs[None, :], (ty_n + 1, tx_n + 1))
    cy = np.broadcast_to(ys[:, None], (ty_n + 1, tx_n + 1))
    dirs = np.stack([camera.lower_left_x + camera.view_x * cx,
                     camera.lower_left_y + camera.view_y * cy,
                     np.full(cx.shape, -1.0)], axis=-1)
    return np.stack([dirs[:-1, :-1], dirs[:-1, 1:], dirs[1:, :-1],
                     dirs[1:, 1:]], axis=2).reshape(-1, 4, 3)


def build_tile_tri_table(camera, tri_a, tri_e1, tri_e2, width: int,
                         height: int, bvh, backface_cull: bool = False,
                         flip_y: bool = False) -> TileTriTable:
    """Conservative cull of every triangle's box against every 32x32 tile
    frustum, gathered into the flat chunk table; indices stay ascending per
    tile so the kernel's strict-< running min picks the lowest index on
    ties. flip_y picks the consumer's film map, for the planes and the
    back-face cull's corners alike: the PPM eye pass's cy = y/H (False) or
    the path tracer's cy = 1 - y/H (True). Either way tile (ty, tx) holds
    the raster rows [32 ty, 32 ty + 32) of the consumer's lanes.

    bvh: the MeshBVH over the same (BVH-ordered) triangle arrays. The cull
    is one stackless descent per tile in C++ (native.tile_cull): a node
    failing a cone plane skips its subtree, and surviving leaves test each
    triangle's box with a margin of 1e-5 * its scale (covering the f32 ray
    against the f64 plane).

    backface_cull (for a watertight mesh seen from outside, the caller's
    contract): drop the triangles every ray of the tile can only hit from
    behind. The tile's directions are the conical hull of its 4 corner
    directions, so all four corner dots being positive proves it; the
    winding's orientation comes from the mesh's signed volume."""
    tri_a = np.asarray(tri_a, np.float32)
    tri_e1 = np.asarray(tri_e1, np.float32)
    tri_e2 = np.asarray(tri_e2, np.float32)
    b = tri_a + tri_e1
    c = tri_a + tri_e2
    lo = np.minimum(np.minimum(tri_a, b), c)
    hi = np.maximum(np.maximum(tri_a, b), c)
    scale = np.maximum(np.abs(hi), np.abs(lo)).max(axis=1)
    margin = (1e-5 * np.maximum(scale, 1.0) + 1e-6).astype(np.float32)

    tx_n = -(-width // TILE)
    ty_n = -(-height // TILE)
    planes = tile_frustum_planes(camera, width, height, tx_n, ty_n,
                                 flip_y=flip_y, with_z_plane=True, tile=TILE)
    t_n = planes.shape[0]
    n = len(tri_a)
    keep = (native.tile_cull(bvh.nodes_lo, bvh.nodes_hi, bvh.meta_np, lo, hi,
                             margin, planes) if n
            else np.zeros((t_n, 0), bool))

    if backface_cull and n:
        corners = _tile_corner_dirs(camera, width, height, tx_n, ty_n,
                                    flip_y=flip_y)
        normals = np.cross(tri_e1.astype(np.float64),
                           tri_e2.astype(np.float64))
        vol6 = float(np.einsum("ij,ij->", tri_a.astype(np.float64), normals))
        s_out = 1.0 if vol6 >= 0.0 else -1.0
    idx_lists = []
    for t in range(t_n):
        idx = np.nonzero(keep[t])[0]
        if backface_cull and n and len(idx):
            d4 = (s_out * normals[idx]) @ corners[t].T  # (k, 4)
            # keep unless all corner dots are positive beyond rounding doubt
            m = np.abs(normals[idx]).sum(1) * np.abs(corners[t]).sum(1).max()
            idx = idx[d4.min(axis=1) <= 1e-12 * np.maximum(m, 1e-300)]
        idx_lists.append(idx)
    counts = np.array([len(i) for i in idx_lists], np.int64)
    pad_counts = np.maximum(-(-counts // CHUNK) * CHUNK, CHUNK)
    starts = np.zeros(t_n + 1, np.int64)
    np.cumsum(pad_counts, out=starts[1:])
    r_total = int(starts[-1]) + CHUNK  # + the shared zero chunk
    table = np.zeros((16, r_total), np.float32)
    for t, idx in enumerate(idx_lists):
        s0, k = int(starts[t]), len(idx)
        table[0:3, s0:s0 + k] = tri_a[idx].T
        table[3:6, s0:s0 + k] = tri_e1[idx].T
        table[6:9, s0:s0 + k] = tri_e2[idx].T
        table[9, s0:s0 + k] = idx  # exact in f32 (mesh < 2^24 triangles)

    tile_chunk_start = (starts // CHUNK).astype(np.int32)
    chunk_src = np.arange(int(tile_chunk_start[-1]), dtype=np.int32)
    zero_chunk = r_total // CHUNK - 1
    for t in np.nonzero(counts == 0)[0]:
        chunk_src[tile_chunk_start[t]:tile_chunk_start[t + 1]] = zero_chunk
    return TileTriTable(table=table, tile_chunk_start=tile_chunk_start,
                        tile_chunk_src=chunk_src, tx_n=tx_n, ty_n=ty_n,
                        width=width, height=height)


def band_tile_maps(tt: TileTriTable, tile_row0: int, band_tile_rows: int):
    """The CSR maps of one band of tile rows [tile_row0, tile_row0 +
    band_tile_rows): (tile_chunk_start (n+1,) rebased to 0,
    tile_chunk_src) int32 over the band's n = band_tile_rows * tx_n tiles,
    the table's own chunk sources for the tiles inside the image and one
    entry, the zero chunk, for each tile row past it. The port of JAX
    band_chunk_maps in CSR form: the kernel runs over every chunk of
    tile_chunk_src and gives chunk c to the last tile t with start(t) <= c,
    so the sources are cut to the band's, not the starts alone."""
    rows_in = max(0, min(tile_row0 + band_tile_rows, tt.ty_n) - tile_row0)
    g0 = min(tile_row0, tt.ty_n) * tt.tx_n
    g1 = g0 + rows_in * tt.tx_n
    c0 = int(tt.tile_chunk_start[g0])
    start = tt.tile_chunk_start[g0:g1 + 1] - c0
    n_dead = (band_tile_rows - rows_in) * tt.tx_n
    start = np.concatenate([start, start[-1] + np.arange(1, n_dead + 1)])
    src = np.concatenate([tt.tile_chunk_src[c0:int(tt.tile_chunk_start[g1])],
                          np.full(n_dead, tt.zero_chunk, np.int64)])
    return start.astype(np.int32), src.astype(np.int32)


def lane_maps(width: int, band_rows: int, tx_n: int):
    """Raster <-> tile lane permutations of one band (copy of the JAX
    lane_maps). Returns (src_lane ((n_tiles+1)*1024,) int32: the raster lane
    feeding each tile lane, 0 past the width and for the trailing dummy
    block; back ((ceil(band_rows*width/1024)*1024,) int32: the tile lane
    owning each raster lane, pad lanes clamped into the band). Raster
    lanes are lane = y * width + x."""
    tile_rows = band_rows // TILE
    n_tiles = tile_rows * tx_n
    tl = np.arange(n_tiles * TILE * TILE)
    tile_id = tl // (TILE * TILE)
    within = tl % (TILE * TILE)
    ly = within // TILE
    lx = within % TILE
    ty, tx = tile_id // tx_n, tile_id % tx_n
    y = ty * TILE + ly
    x = tx * TILE + lx
    src = np.where(x < width, y * width + np.minimum(x, width - 1),
                   0).astype(np.int32)
    src_lane = np.concatenate([src, np.zeros(TILE * TILE, np.int32)])

    n_pix = band_rows * width
    lanes = -(-n_pix // 1024) * 1024
    rl = np.arange(lanes)
    ry = np.minimum(rl // width, band_rows - 1)
    rx = np.minimum(rl % width, width - 1)
    rtile = (ry // TILE) * tx_n + rx // TILE
    back = (rtile * TILE * TILE + (ry % TILE) * TILE
            + (rx % TILE)).astype(np.int32)
    return src_lane, back


def _check(table, tile_chunk_start, tile_chunk_src, d, width,
           contiguous: bool):
    """The wrapper's contract (contiguity for the kernel only); returns
    (rows, tx_n, n_tiles)."""
    n = d.shape[0]
    tx_n = -(-width // TILE)
    rows = n // width if width > 0 else 0
    n_tiles = tile_chunk_start.shape[0] - 1
    ok = (table.dim() == 2 and table.shape[0] == 16
          and table.shape[1] % CHUNK == 0 and table.dtype == torch.float32
          and d.dim() == 2 and d.shape[1] == 3 and d.dtype == torch.float32
          and rows * width == n and rows % TILE == 0
          and n_tiles == (rows // TILE) * tx_n
          and tile_chunk_start.dtype == tile_chunk_src.dtype == torch.int32
          and all(x.device == d.device and (x.is_contiguous() or not contiguous)
                  for x in (table, tile_chunk_start, tile_chunk_src, d)))
    if not ok:
        raise ValueError(
            "intersect_tile_tris: want a contiguous f32 (16, R) table with R "
            f"% {CHUNK} == 0, int32 CSR maps over (rows/32)*ceil(width/32) "
            "tiles and raster directions (rows*width, 3) f32 with rows % 32 "
            f"== 0, all on one device; got table {tuple(table.shape)}, "
            f"{n_tiles} tiles, d {tuple(d.shape)} {d.dtype} at width {width}")
    return rows, tx_n, n_tiles


def intersect_tile_tris_plain(table, tile_chunk_start, tile_chunk_src, d,
                              width: int, tiles=None):
    """Plain PyTorch version of intersect_tile_tris, in the JAX kernel's
    order of operations. tiles: the tile indices to compute (default all);
    lanes of the other tiles read as misses. Returns (t, u, v, idx int32),
    each (rows*width,) in raster order.

    Chunk position k runs over all tiles at once: per tile, the first column
    attaining the least accepted t replaces the running best only if that t
    is strictly smaller. That equals the kernel's sequential strict-<
    running minimum, since an accepted t is never NaN."""
    rows, tx_n, n_tiles = _check(table, tile_chunk_start, tile_chunk_src, d,
                                 width, contiguous=False)
    dev = d.device
    tiles = (torch.arange(n_tiles, device=dev) if tiles is None
             else torch.as_tensor(tiles, dtype=torch.int64, device=dev))
    src_lane, back = lane_maps(width, rows, tx_n)
    src_lane = torch.as_tensor(src_lane[:n_tiles * TILE * TILE],
                               dtype=torch.int64, device=dev)
    dt = d[src_lane.reshape(n_tiles, TILE * TILE)[tiles]]  # (k, 1024, 3)
    d0, d1, d2 = (dt[..., c, None] for c in range(3))  # (k, 1024, 1)
    start = tile_chunk_start.long()
    first, count = start[tiles], start[tiles + 1] - start[tiles]
    k = tiles.shape[0]
    best_t = torch.full((k, TILE * TILE), BIG, device=dev)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_i = torch.zeros((k, TILE * TILE), dtype=torch.int32, device=dev)
    col = torch.arange(CHUNK, device=dev)
    n_pos = int(count.max()) if k else 0
    for c in range(n_pos):
        live = c < count  # (k,)
        # every tile has at least one chunk; finished tiles re-read their
        # last one and do not update
        src = tile_chunk_src.long()[first + torch.clamp(count - 1, max=c)]
        cols = src[:, None] * CHUNK + col  # (k, CHUNK)
        tri = table[:_ROWS][:, cols][:, :, None, :]  # (10, k, 1, CHUNK)
        ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z, gi = tri
        pvx = d1 * e2z - d2 * e2y
        pvy = d2 * e2x - d0 * e2z
        pvz = d0 * e2y - d1 * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv = 1.0 / det
        uu = -inv * (ax * pvx + ay * pvy + az * pvz)
        qvx = az * e1y - ay * e1z
        qvy = ax * e1z - az * e1x
        qvz = ay * e1x - ax * e1y
        vv = inv * (d0 * qvx + d1 * qvy + d2 * qvz)
        tt = inv * (e2x * qvx + e2y * qvy + e2z * qvz)
        ok = ((torch.abs(det) >= _EPS) & (uu >= 0.0) & (uu <= 1.0)
              & (vv >= 0.0) & (uu + vv <= 1.0) & (tt >= 0.0))
        cand = torch.where(ok, tt, torch.inf)  # (k, 1024, CHUNK)
        m = cand.amin(dim=-1)
        j = torch.where(cand == m[..., None], col, CHUNK).amin(dim=-1)
        j = torch.clamp(j, max=CHUNK - 1)[..., None]
        upd = (m < best_t) & live[:, None]
        best_t = torch.where(upd, tt.gather(-1, j)[..., 0], best_t)
        best_u = torch.where(upd, uu.gather(-1, j)[..., 0], best_u)
        best_v = torch.where(upd, vv.gather(-1, j)[..., 0], best_v)
        idx = gi.expand(-1, TILE * TILE, -1).gather(-1, j)[..., 0]
        best_i = torch.where(upd, idx.to(torch.int32), best_i)
    # tile-major results (misses for tiles not computed), then raster order
    back = torch.as_tensor(back[:rows * width], dtype=torch.int64, device=dev)
    out = []
    for x, fill in ((best_t, BIG), (best_u, 0.0), (best_v, 0.0),
                    (best_i, 0)):
        full = torch.full((n_tiles, TILE * TILE), fill, dtype=x.dtype,
                          device=dev)
        full[tiles] = x
        out.append(full.reshape(-1)[back])
    return tuple(out)


def intersect_tile_tris(table, tile_chunk_start, tile_chunk_src, d,
                        width: int):
    """Nearest hit of the origin-zero primary rays of a (rows, width) image
    band against their tiles' culled lists (the JAX
    intersect_tile_tris_pallas). table (16, R) f32, tile_chunk_start
    (n_tiles+1,) and tile_chunk_src (C,) int32 from TileTriTable.tensors;
    d (rows*width, 3) f32 unit directions in raster order, rows a multiple
    of 32. Returns (t, u, v, idx int32), each (rows*width,) in raster
    order; t = BIG on a miss.

    CPU tensors run intersect_tile_tris_plain; CUDA tensors launch
    csrc/intersect_tile_tris.cu (its two passes counted as one launch in
    `intersect_tile_tris.launches`); anything else raises."""
    if d.device.type == "cpu":
        return intersect_tile_tris_plain(table, tile_chunk_start,
                                         tile_chunk_src, d, width)
    if d.device.type != "cuda":
        raise ValueError(f"intersect_tile_tris: no kernel for {d.device}")
    rows, tx_n, n_tiles = _check(table, tile_chunk_start, tile_chunk_src, d,
                                 width, contiguous=True)
    if table.data_ptr() % 16:
        raise ValueError("intersect_tile_tris: the table must be 16-byte "
                         "aligned (the kernel stages it with 16-byte copies)")
    n, n_chunks = d.shape[0], tile_chunk_src.shape[0]
    lib = _build.load()
    partial = torch.empty(n_chunks, 4, TILE * TILE, dtype=torch.float32,
                          device=d.device)
    t = torch.empty(n, dtype=torch.float32, device=d.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    idx = torch.empty(n, dtype=torch.int32, device=d.device)
    err = lib.pt_intersect_tile_tris(
        table.data_ptr(), table.shape[1], tile_chunk_start.data_ptr(),
        tile_chunk_src.data_ptr(), n_tiles, tx_n, n_chunks, d.data_ptr(),
        width, partial.data_ptr(), t.data_ptr(), u.data_ptr(), v.data_ptr(),
        idx.data_ptr(),
        torch.cuda.current_stream(d.device).cuda_stream)
    _build.check(lib, err, "intersect_tile_tris")
    intersect_tile_tris.launches += 1
    return t, u, v, idx


intersect_tile_tris.launches = 0


def intersect_band(tile, d, alive, width: int, rows: int):
    """The mesh hits of origin-zero primaries in raster lanes through
    intersect_tile_tris, in integrator.Intersector's mesh_intersect contract:
    tile the (table, tile_chunk_start, tile_chunk_src) tensors; d (N, 3)
    f32 with N >= rows * width, rows a multiple of 32; alive (N,) bool.
    The band's lanes go through the kernel, the lanes past it read as
    misses. Returns (t, u, v, idx int32, hit), each (N,)."""
    n = rows * width
    t, u, v, idx = intersect_tile_tris(*tile, d[:n], width)
    pad = d.shape[0] - n
    t = torch.nn.functional.pad(t, (0, pad), value=BIG)
    u, v, idx = (torch.nn.functional.pad(x, (0, pad)) for x in (u, v, idx))
    return t, u, v, idx, (t < BIG) & alive
