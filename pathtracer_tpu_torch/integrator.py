"""Bounce-synchronous wavefront path tracer for sphere scenes and for mesh
scenes, and the composite sphere + triangle intersector of both the path
tracer's mesh scenes and the photon mapper.

Port of pathtracer_tpu/integrator.py: make_intersector (Intersector, with
its mesh branch; without the onehot select), the tiled pass (make_pass_fn's
32x32-tile-major ray order), the kernel wavefront (_trace_pallas2), the
composite mesh wavefront (trace), the bounce-0 per-tile sphere lists
(tile_sphere_lists, a numpy copy) and the render driver (make_render_fn,
with `mesh` the MeshRenderer). Sampling follows the JAX package:

  - sampler dimension count D = 2 + 2*max_bounces
  - sample offset = y*W + x + pass*spp   (pass*spp, not pass*W*H)
  - dims (0, 1) jitter the pixel; dims (2+2i, 3+2i) drive bounce i
  - cx = (x+dx)/W, cy = 1-(y+dy)/H (flip_y)

The wavefront is the JAX kernel layout: state (10, rows, 128) f32 planes
[org3, dir3, attn3, alive], offsets (rows, 128) int32 (uint32 bit patterns)
and radiance (3, rows, 128). Every bounce is one fused_bounce kernel, or
with fuse_bounce=False the two-kernel bounce (intersect_state, then
shade_state: the JAX path under PATHTRACER_FUSE_BOUNCE=0, which gives the
same image bit for bit). The two-kernel bounce is a parity path, which runs
the ports of the JAX package's two-kernel Pallas kernels, not a tuning
option: it is slower on the card. Lane compaction runs at the
_default_compact_at bounces.

Design choice, not a port of the JAX code: the JAX package pre-sizes
lax.switch buckets for the post-compaction wavefront because TPU shapes are
static. Here the remaining bounces run over all the rows, the live lanes
packed into the first ones and dead rows after them, so a pass reads
nothing back to the host and has one shape, and a card replays it as one
CUDA graph. The dead rows pass through the bounce.

A scene with a triangle mesh (ops.bvh.MeshBVH; the path-traced ganesha)
takes the JAX composite tier instead: every bounce is the Intersector
(the sphere and triangle pool kernels, the BVH8 walk kernel capped at the
pools' winner t), the sky on a miss, then shading.scatter, over (N, 3)
rays. Bounce 0 meets the mesh through the tile-culled triangle kernel. On
a card the pools' winner t and all of a bounce after the mesh query are
the two kernels of ops/cuda/mesh_bounce_kernel.py; their plain version,
which the CPU runs, is the eager code of trace_plain (composite_hits,
scatter_bounce), which the photon mapper's hit_setup shares. Not ported:
the PT mesh compaction ladder (measured neutral in the JAX package, off by
default there).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import film
from .camera import Camera
from .ops import quat as quat_ops
from .ops import shading, vec
from .ops.cuda import compact_kernel as ck
from .ops.cuda import fused_bounce_kernel as fbk
from .ops.cuda import tile_tri_kernel as ttk
from .ops.cuda.shade_kernel import pack_material_tables, shade_state
from .ops.cuda.sphere_kernel import (BIG, LANES, LIST_UNROLL, SphereBVH,
                                     build_sphere_bvh, intersect_spheres,
                                     intersect_state, pack_spheres)
from .ops.cuda.tri_kernel import intersect_tris, pack_tris
from .ops.frustum import tile_frustum_planes
from .ops.lds import M32, Sampler
from .ops.spheres import stable_t
from .ops.triangles import mt_single
from .scene import (TRI_A, TRI_E1, TRI_E2, TRI_MAT, TRI_TEX, Scene,
                    eval_texture)
from .utils import tracing

__all__ = ["Intersector", "composite_hits", "TILE",
           "tile_sphere_lists", "initial_state", "trace_wavefront",
           "Renderer", "trace", "trace_plain", "scatter_bounce",
           "MeshRenderer", "renderer_per_scene", "make_render_fn"]

_f32 = lambda x: float(np.float32(x))
_PI = _f32(np.pi)
_TWO_PI_INV = _f32(0.5 / np.pi)
_PI_INV = _f32(1.0 / np.pi)


class Intersector:
    """hit_setup(org, d, alive) -> dict of per-lane hit attributes over
    both pools of a mixed scene, the nearest sphere (intersect_spheres) and
    the nearest triangle (intersect_tris), and over an optional triangle
    mesh (ops.bvh.MeshBVH): the nearest of them, and every shading input
    (point, flipped normal, uv, material columns) by masked selects. org,
    d (N, 3) f32 with N a multiple of 1024; alive (N,) bool drives the
    kernels' block early exit.

    The mesh walk (MeshBVH.intersect, the BVH8 or BVH4 walk kernel) is
    capped at the pools' winner t, as the reference's floor-then-mesh
    intersect passes the floor hit as the mesh query's t_max.
    mesh_intersect(org, d, alive) -> (t, u, v, idx, hit) replaces the walk
    (the eye pass's tile-culled kernel). A mesh winner's attributes come
    from one gather of the mesh's (9, T) [a | e1 | e2] pack, its point is
    the barycentric a + u e1 + v e2, its tex coords are (v, u + v) and its
    material the mesh's row.

    hit_setup returns dict(hit, t, point, normal, hit_front, albedo,
    mat_kind, ior, ior_inv). The uv of a sphere hit uses torch.acos /
    torch.atan2, the library functions of the JAX code (not the
    polynomials of the path tracer's kernel). It runs in two stages, which
    the mesh path tracer's kernels take apart (trace): `pools`, the sphere
    and triangle pool kernels, then composite_hits, the eager combine,
    which calls `query` (the walk or mesh_intersect) at the pools' winner
    t. It holds the scene, the mesh (or None) and the pools' packed
    tables, and no renderer."""

    def __init__(self, scene: Scene, mesh=None, mesh_intersect=None):
        self.scene, self.mesh = scene, mesh
        self.mesh_intersect = mesh_intersect
        self.sph_table = pack_spheres(scene.center, scene.radius, scene.valid)
        self.tri_table = None
        if scene.tri_count > 0:
            tp = scene.tri_pack
            self.tri_table = pack_tris(tp[:, TRI_A], tp[:, TRI_E1],
                                       tp[:, TRI_E2], scene.tri_valid)

    def pools(self, org, d, alive):
        """(at, idx_s, hit_s, inv_a, t_t, idx_t, hit_t): intersect_spheres'
        nearest sphere and intersect_tris' nearest triangle of each ray;
        the last three are None without a triangle pool."""
        at, idx_s, hit_s, inv_a = intersect_spheres(self.sph_table, org, d,
                                                    alive)
        tris = (None, None, None)
        if self.tri_table is not None:
            tris = intersect_tris(self.tri_table, org, d, alive)
        return (at, idx_s, hit_s, inv_a, *tris)

    def query(self, org, d, t_cur, alive):
        """The mesh's (t, u, v, idx, hit): mesh_intersect's, or the walk's
        capped at t_cur (the pools' winner t)."""
        if self.mesh_intersect is not None:
            with tracing.span("pt.tile"):
                return self.mesh_intersect(org, d, alive)
        with tracing.span("pt.walk"):
            return self.mesh.intersect(org, d, t_cur, alive)

    def __call__(self, org, d, alive):
        return composite_hits(self.scene, self.mesh, self.pools(org, d, alive),
                              org, d, lambda t_cur: self.query(org, d, t_cur,
                                                               alive))



def composite_hits(scene: Scene, mesh, pools, org, d, query):
    """hit_setup's combine, eager: the nearest of the pools' winners
    (Intersector.pools' outputs) and, with a mesh, of query(t_cur), the
    mesh's (t, u, v, idx, hit) capped at the pools' winner t, and every
    shading input of the winner. The plain version of the mesh path
    tracer's two kernels (ops/cuda/mesh_bounce_kernel.py): winner_t is the
    t_cur it passes to query, mesh_bounce's selects are the rest."""
    at, idx_s, hit_s, inv_a, t_t, idx_t, hit_t = pools
    has_tris = t_t is not None
    has_mesh = mesh is not None
    pk_rows = scene.shade_pack[idx_s.long()]
    # stable per-ray t from the winner's parameters
    r_h = pk_rows[:, 3]
    t_s = stable_t(pk_rows[:, 0:3], r_h * r_h, org, d, vec.quadrance(d),
                   inv_a)
    if has_tris:
        tri_rows = scene.tri_pack[idx_t.long()]
        use_tri = hit_t & (~hit_s | (t_t < t_s))
        hit = hit_s | hit_t
    else:
        use_tri = torch.zeros_like(hit_s)
        hit = hit_s
    if has_mesh:
        t_cur = torch.where(hit, torch.where(use_tri, t_t, t_s)
                            if has_tris else t_s, BIG)
        t_m, u_m, v_m, idx_m, hit_m = query(t_cur)
        use_mesh = hit_m & (t_m < t_cur)
        use_tri = use_tri & ~use_mesh
        hit = hit | hit_m

    point_s = org + t_s[:, None] * d
    n_s = vec.normalize(point_s - pk_rows[:, 0:3])
    if has_tris:
        a, e1, e2 = tri_rows[:, TRI_A], tri_rows[:, TRI_E1], \
            tri_rows[:, TRI_E2]
        _, u_b, v_b = mt_single(a, e1, e2, org, d)
        # the hit point is the barycentric combination, not o + t*d
        point_t = a + u_b[:, None] * e1 + v_b[:, None] * e2
        n_t = vec.normalize(vec.cross(e1, e2))
        point = vec.where3(use_tri, point_t, point_s)
        g_normal = vec.where3(use_tri, n_t, n_s)
        t = torch.where(use_tri, t_t, t_s)
    else:
        point, g_normal, t = point_s, n_s, t_s
    if has_mesh:
        # one gather, made row-major: the kernels of the next bounce
        # take the hit point's layout as their rays' and want it dense
        cols = mesh.tri_pack9[:, idx_m.long()].T.contiguous()  # (N, 9)
        ma, me1, me2 = cols[:, 0:3], cols[:, 3:6], cols[:, 6:9]
        point_m = ma + u_m[:, None] * me1 + v_m[:, None] * me2
        n_m = vec.normalize(vec.cross(me1, me2))
        point = vec.where3(use_mesh, point_m, point)
        g_normal = vec.where3(use_mesh, n_m, g_normal)
        t = torch.where(use_mesh, t_m, t)

    hit_front = vec.dot(d, g_normal) < 0.0
    normal = vec.where3(hit_front, g_normal, -g_normal)

    # sphere uv from the flipped normal
    ny = torch.clamp(normal[:, 1], -1.0, 1.0)
    theta = torch.acos(-ny)
    phi = _PI + torch.atan2(-normal[:, 2], normal[:, 0])
    u_tex = phi * _TWO_PI_INV
    v_tex = theta * _PI_INV
    mat_rows = pk_rows[:, 4:16]
    if has_tris:
        # triangle uv: barycentric interpolation of the tex coords
        tx = tri_rows[:, TRI_TEX]
        w_b = 1.0 - u_b - v_b
        tri_u = tx[:, 0] * w_b + tx[:, 2] * u_b + tx[:, 4] * v_b
        tri_v = tx[:, 1] * w_b + tx[:, 3] * u_b + tx[:, 5] * v_b
        u_tex = torch.where(use_tri, tri_u, u_tex)
        v_tex = torch.where(use_tri, tri_v, v_tex)
        mat_rows = torch.where(use_tri[:, None], tri_rows[:, TRI_MAT],
                               mat_rows)
    if has_mesh:
        # the mesh's fixed (t00, t01, t11) tex corners: tu = v, tv = u+v
        u_tex = torch.where(use_mesh, v_m, u_tex)
        v_tex = torch.where(use_mesh, u_m + v_m, v_tex)
        mat_rows = torch.where(use_mesh[:, None], mesh.mat_row_t[None, :],
                               mat_rows)

    albedo = eval_texture(mat_rows[:, 1], mat_rows[:, 2:5],
                          mat_rows[:, 5:8], mat_rows[:, 8],
                          mat_rows[:, 9], u_tex, v_tex)
    return dict(hit=hit, t=t, point=point, normal=normal,
                hit_front=hit_front, albedo=albedo,
                mat_kind=mat_rows[:, 0], ior=mat_rows[:, 10],
                ior_inv=mat_rows[:, 11])


TILE = 32  # pixels per side of an image tile in tiled ray order


def _default_compact_at(max_bounces: int) -> tuple[int, ...]:
    """Compaction schedule of the JAX package (measured there): one
    compaction at bounce 3 for shallow renders, (2, 4) for deeper ones."""
    return (3,) if max_bounces <= 8 else (2, 4)


def tile_sphere_lists(camera, center, radius, valid, width, height,
                      tile_rows=None):
    """Frustum-cull the sphere set per 32x32 image tile (host numpy, f64).

    Copy of the JAX integrator.tile_sphere_lists. Returns (lists (T, K)
    int32, counts (T, 1) int32): ascending global sphere indices per tile,
    counts padded to a multiple of LIST_UNROLL with duplicates of the first
    entry (a duplicate can never steal the strict-< minimum). tile_rows
    (default ceil(height/32)) may exceed the image: a band that overhangs
    the image bottom then has lists too (its rays are dead)."""
    center = np.asarray(center, np.float64)
    radius = np.asarray(radius, np.float64)
    valid = np.asarray(valid, bool)
    tyn = tile_rows if tile_rows is not None else -(-height // TILE)
    txn = -(-width // TILE)
    planes = tile_frustum_planes(camera, width, height, txn, tyn,
                                 flip_y=True, tile=TILE)  # (T, 4, 3)
    # conservative margin: kernel directions are f32 while the cone is f64
    r_eff = radius + 1e-4 * (1.0 + np.linalg.norm(center, axis=1))
    dist = np.einsum("tpk,sk->tps", planes, center)  # (T, 4, S)
    vis = (dist >= -r_eff[None, None, :]).all(axis=1) & valid[None, :]
    counts = vis.sum(axis=1)
    k_pad = max(int(-(-counts.max() // LIST_UNROLL)) * LIST_UNROLL,
                LIST_UNROLL)
    t_n = vis.shape[0]
    lists = np.zeros((t_n, k_pad), np.int32)
    counts_pad = np.zeros((t_n, 1), np.int32)
    for t in range(t_n):
        idx = np.nonzero(vis[t])[0]
        c = len(idx)
        cp = -(-c // LIST_UNROLL) * LIST_UNROLL if c else 0
        lists[t, :c] = idx
        if cp > c:
            lists[t, c:cp] = idx[0]
        counts_pad[t, 0] = cp
    return lists, counts_pad


def initial_state(d: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """(10, N/128, 128) wavefront state of rays from the origin: d (N, 3)
    f32 unit directions, alive (N,) bool; attenuation starts at 1."""
    n = d.shape[0]
    planes = torch.cat([torch.zeros(3, n, dtype=d.dtype, device=d.device),
                        d.T, torch.ones(3, n, dtype=d.dtype, device=d.device),
                        alive.to(d.dtype)[None]])
    return planes.reshape(10, n // LANES, LANES)


def _to_orig(rad: torch.Tensor, chain) -> torch.Tensor:
    """Radiance of the current (compacted) wavefront back in original lane
    order, (3, N0). chain: per compaction, (alive before it (n,) bool, its
    dest_map (n,) int32). Dead lanes' dest entries are garbage, so their
    index is masked to 0 before the gather."""
    x = rad.reshape(3, -1)
    for alive, dest in reversed(chain):
        idx = torch.where(alive, dest, 0).to(torch.int64)
        x = torch.where(alive, x[:, idx], 0.0)
    return x


def _two_kernel_bounce(sph_table, state, pack_table, off, limbs, bg, rad, *,
                       bg_mode: int, origin_zero: bool, block_lists=None,
                       sphere_bvh=None):
    """One bounce as intersect_state, then shade_state: fused_bounce's
    contract in two kernels."""
    at, idx = intersect_state(sph_table, state, origin_zero=origin_zero,
                              block_lists=block_lists, sphere_bvh=sphere_bvh)
    return shade_state(state, pack_table, idx, off, at, limbs, bg, rad,
                       bg_mode=bg_mode)


def trace_wavefront(sph_table, pack_table, state, off, sampler: Sampler,
                    max_bounces: int, background, *, origin_zero: bool,
                    block_lists0=None, sphere_bvh=None,
                    fuse_bounce: bool = True):
    """Trace the wavefront to completion (the JAX _trace_pallas2).

    sph_table (4, S); pack_table (10, Sq, 128); state (10, rows, 128);
    off (rows, 128) int32; background (bg_mode, colors); block_lists0:
    bounce-0 per-block sphere lists (tile-major rays only); sphere_bvh:
    build_sphere_bvh of sph_table, which the kernels walk at the bounces
    that have no lists (the plain versions do not read it); fuse_bounce:
    each bounce is one fused_bounce (True) or intersect_state then
    shade_state (False, the parity path of the module docstring).
    Returns (radiance (3, rows, 128) in the input lane order, segments
    0-dim int64 tensor on the device).

    Every bounce runs over all the rows, so no value goes to the host,
    and counts them all in pt.lanes. After a compaction the live lanes are
    packed into the first rows (pack_rows' count, which stays on the
    device) and the rows past them are dead and zero: compact_blocks
    writes every lane of a block, its tail zeroed and dead, pack_rows
    moves whole rows, and the bounce writes every lane, passing a dead one
    through. The radiance starts again at zero, so those rows add nothing
    to the segments or the radiance, and _to_orig reads no lane of
    theirs."""
    bg_mode, bg = background
    bounce_fn = fbk.fused_bounce if fuse_bounce else _two_kernel_bounce
    compact_at = {b for b in _default_compact_at(max_bounces)
                  if 0 < b < max_bounces}
    rows = state.shape[1]
    dev = state.device
    rad = torch.zeros(3, rows, LANES, dtype=torch.float32, device=dev)
    flush = torch.zeros(3, rows * LANES, dtype=torch.float32, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    chain = []
    for bounce in range(max_bounces):
        with tracing.span("pt.bounce"):
            if bounce in compact_at:
                with tracing.span("pt.compact"):
                    flush += _to_orig(rad, chain)
                    alive_pre = state[9] > 0.0
                    st_c, off_c, k = ck.compact_blocks(state, off)
                    state, off, _ = ck.pack_rows(st_c, off_c, k)
                    chain.append((alive_pre.reshape(-1),
                                  ck.dest_map(alive_pre, k)))
                    rad = torch.zeros_like(rad)
            tracing.count("pt.lanes", rows * LANES)
            segments += (state[9] > 0.0).sum()
            state, rad = bounce_fn(
                sph_table, state, pack_table, off,
                sampler.limbs(2 + 2 * bounce, 3 + 2 * bounce), bg, rad,
                bg_mode=bg_mode, origin_zero=origin_zero and bounce == 0,
                block_lists=block_lists0 if bounce == 0 else None,
                sphere_bvh=sphere_bvh)
    with tracing.span("pt.compact"):
        flush += _to_orig(rad, chain)
    return flush.reshape(3, rows, LANES), segments


class _BandRenderer(torch.nn.Module):
    """What both path tracers share: the band of tile rows they trace, the
    sampler, the primaries' pixel draws, the passes' sums and the film.
    forward(progress=None) -> (image (H, W, 3) f32 on the device, segments
    traced, int, read once at the end).

    tile_row0, band_tile_rows: trace the band of tile rows [tile_row0,
    tile_row0 + band_tile_rows) only (default: from tile_row0 to the
    image's last tile row); rows past the image are dead lanes. band_sums
    and band_image give the band's raw sums before any film step (the
    sharded render, parallel/mesh.py). Each lane's result does not depend
    on the band it is traced in, so stitched bands equal the whole image
    bit for bit. The sums and segments are buffers that each band_sums
    zeroes and adds every pass into (a CUDA graph's static outputs on a
    card); band_sums returns copies of them.

    On a CUDA device band_sums adds each pass as a CUDA graph (graph.Replay,
    loaded there and nowhere else): the renderer's first pass eagerly, as
    the warm-up before the capture, every later one as a replay of the
    captured pass, to the same sums bit for bit. A pass reads nothing back
    to the host, so the image's one read of the device is its closing
    pt.sync. On the CPU, and under another graph's capture, the passes run
    eagerly."""

    def __init__(self, camera: Camera, background, width: int, height: int,
                 spp: int, max_bounces: int, tile_row0: int,
                 band_tile_rows: int | None):
        super().__init__()
        self.camera = camera
        self.background = background
        self.width, self.height = width, height
        self.spp, self.max_bounces = spp, max_bounces
        self.sampler = Sampler(2 + 2 * max_bounces)
        self.tyn, self.txn = -(-height // TILE), -(-width // TILE)
        self.tile_row0 = tile_row0
        self.band = (self.tyn - tile_row0 if band_tile_rows is None
                     else band_tile_rows)
        # the band's pixels inside the image
        self.band_pixels = max(0, min(self.band * TILE,
                                      height - TILE * tile_row0)) * width
        self._graph = None  # the pass's Replay, made at a pass on a card

    def _register(self, device, **arrays) -> None:
        """Register each array as a buffer on `device`, with the segments
        and the film's reconstruction filter (the JAX make_render_fn's
        defaults)."""
        arrays["segments"] = np.zeros((), np.int64)
        arrays["kern2d"] = film.binomial_kernel_2d(
            order=5, pixel_radius=1).astype(np.float32)
        for name, x in arrays.items():
            self.register_buffer(name, torch.as_tensor(x).to(device))

    def _camera_rays(self, pix, x, y, pass_idx):
        """One pass's primaries through the pixels (x, y), pix = y*W + x:
        (sample offsets (pix + pass*spp) & M32, unit directions). pass_idx
        is an int or a 0-dim int64 tensor on the renderer's device (a CUDA
        graph's input), to the same offsets."""
        offset = (pix + pass_idx * self.spp) & M32
        dx = self.sampler.get(offset, 0)
        dy = self.sampler.get(offset, 1)
        cx = (x + dx) * float(np.float32(1.0 / self.width))
        cy = 1.0 - (y + dy) * float(np.float32(1.0 / self.height))
        return offset, self.camera.ray_dirs(cx, cy)

    def _add_pass(self, pass_idx) -> None:
        """Pass `pass_idx` added into the sums and segments."""
        rad, segs = self.trace_pass(pass_idx)
        self.sums += rad
        self.segments += segs

    def _pass_adder(self):
        """The function band_sums adds each pass with: _add_pass, or on a
        card its Replay."""
        if not self.sums.is_cuda or torch.cuda.is_current_stream_capturing():
            return self._add_pass
        if self._graph is None:
            from .graph import Replay
            self._graph = Replay(_BandRenderer._add_pass, 1, self.sums.device,
                                 "pt", "pt.graph_passes")
        return functools.partial(self._graph, self)

    @torch.no_grad()
    def band_sums(self, pass_ids, progress=None):
        """The band's radiance summed over the passes `pass_ids` in their
        order (band_image's input) and the segments traced (a 0-dim int64
        tensor), both fresh tensors. progress, if given, is called with the
        band's pixel count after each pass."""
        add = self._pass_adder()
        self.sums.zero_()
        self.segments.zero_()
        for p in pass_ids:
            add(p)
            tracing.count("pt.passes", 1)
            if progress is not None:
                progress(self.band_pixels)
        return self.sums.clone(), self.segments.clone()

    def image(self, sums: torch.Tensor) -> torch.Tensor:
        """band_sums' radiance -> the band's rows inside the image; (H, W,
        3) for the whole image."""
        return self.band_image(sums)[:max(0, self.height
                                          - TILE * self.tile_row0)]

    untile = image  # the older name, which port_bench's tests call

    def finish(self, img: torch.Tensor) -> torch.Tensor:
        """The summed (rows, W, 3) radiance -> the film: the
        reconstruction filter, then the mean over the spp passes."""
        return film.finalize(film.apply_filter(img, self.kern2d), self.spp)

    # a BVH4 mesh's walk counters (MeshRenderer), else None
    walk_counts = None

    @torch.no_grad()
    def forward(self, progress=None):
        walk = self.walk_counts
        if walk is not None:  # the image's own rays and loads
            walk.zero_()
        sums, segments = self.band_sums(range(self.spp), progress)
        with tracing.span("pt.film"):
            img = self.finish(self.image(sums))
        with tracing.span("pt.sync"):
            if walk is None:
                segments = int(segments)
            else:
                segments, rays, loads = torch.cat([segments.view(1),
                                                   walk]).tolist()
        tracing.count("pt.live_lanes", segments)
        if walk is not None:
            tracing.count("pt.walk_rays", rays)
            if walk.is_cuda:  # the plain walk counts no loads
                tracing.count("pt.walk_loads", loads)
        return img, segments


class Renderer(_BandRenderer):
    """The shirley-style path tracer over one sphere scene: the tiled pass
    loop, the kernel wavefront, film reconstruction. The scene tables, the
    tile-major ray order and the filter are buffers, so `.to(device)` moves
    them. fuse_bounce: one fused kernel per bounce (True) or the two-kernel
    parity path (False). The sphere hierarchy is built at the first pass on
    the card (sphere_hierarchy) and kept with the renderer.

    Each pass runs every bounce over all the band's lanes (trace_wavefront),
    so a pass has fixed shapes and no host read, and a card replays it as a
    CUDA graph (_BandRenderer), with either bounce."""

    def __init__(self, scene: Scene, camera: Camera, background, width: int,
                 height: int, spp: int, max_bounces: int, device,
                 fuse_bounce: bool = True, tile_row0: int = 0,
                 band_tile_rows: int | None = None):
        super().__init__(camera, background, width, height, spp,
                         max_bounces, tile_row0, band_tile_rows)
        self.fuse_bounce = fuse_bounce
        self._sphere_bvh = None

        # 32x32-tile-major ray order: ray i of band tile t is pixel
        # ((tile_row0 + ty)*32 + i // 32, tx*32 + i % 32); edge tiles clamp
        # and mask
        ty, tx, iy, ix = np.meshgrid(
            np.arange(tile_row0, tile_row0 + self.band), np.arange(self.txn),
            np.arange(TILE), np.arange(TILE), indexing="ij")
        y_ord = (ty * TILE + iy).reshape(-1)
        x_ord = (tx * TILE + ix).reshape(-1)
        y_c = np.minimum(y_ord, height - 1)
        x_c = np.minimum(x_ord, width - 1)
        lists, counts = tile_sphere_lists(
            camera, scene.center.cpu().numpy(), scene.radius.cpu().numpy(),
            scene.valid.cpu().numpy(), width, height,
            tile_rows=tile_row0 + self.band)
        first = tile_row0 * self.txn
        self._register(
            device,
            sph_table=pack_spheres(scene.center, scene.radius, scene.valid),
            pack_table=pack_material_tables(scene.shade_pack),
            lists=np.ascontiguousarray(lists[first:]),
            counts=np.ascontiguousarray(counts[first:]),
            pix=(y_c * width + x_c).astype(np.int64),
            x_c=x_c.astype(np.float32), y_c=y_c.astype(np.float32),
            valid=(y_ord < height) & (x_ord < width),
            sums=np.zeros((3, y_ord.size // LANES, LANES), np.float32))

    def sphere_hierarchy(self) -> SphereBVH | None:
        """The sphere hierarchy that the kernels walk at bounces >= 1:
        build_sphere_bvh of sph_table (host work), built at the first call
        on the card and kept. None on the CPU, where the plain versions do
        not read it."""
        if self._sphere_bvh is None and self.sph_table.is_cuda:
            with tracing.span("pt.sphere_bvh"):
                self._sphere_bvh = build_sphere_bvh(self.sph_table)
        return self._sphere_bvh

    def initial_wavefront(self, pass_idx):
        """Bounce-0 (state, off) of one pass in tile-major order."""
        offset, d = self._camera_rays(self.pix, self.x_c, self.y_c, pass_idx)
        state = initial_state(d, self.valid)
        return state, offset.to(torch.int32).reshape(state.shape[1], LANES)

    def trace_pass(self, pass_idx):
        """One sample per pixel: (radiance planes (3, rows, 128) in tile-major
        order, segments tensor). pass_idx as _camera_rays'."""
        with tracing.span("pt.primary"):
            state, off = self.initial_wavefront(pass_idx)
        return trace_wavefront(self.sph_table, self.pack_table, state, off,
                               self.sampler, self.max_bounces,
                               self.background, origin_zero=True,
                               block_lists0=(self.lists, self.counts),
                               sphere_bvh=self.sphere_hierarchy(),
                               fuse_bounce=self.fuse_bounce)

    def band_image(self, planes: torch.Tensor) -> torch.Tensor:
        """(3, rows, 128) tile-major planes -> the band's (band*32, W, 3)
        rows, contiguous (the film's input layout, whatever the band)."""
        img = planes.reshape(3, -1).T.reshape(self.band, self.txn, TILE,
                                              TILE, 3)
        img = img.permute(0, 2, 1, 3, 4).reshape(self.band * TILE,
                                                 self.txn * TILE, 3)
        return img[:, :self.width].contiguous()


def trace(sampler: Sampler, org, d, offset, max_bounces: int, sky_colors,
          alive0, hit_setup, hit_setup0=None):
    """Trace a wavefront of rays through a scene with an optional triangle
    mesh to completion: the JAX trace's composite tier (Intersector,
    shading.scatter) over (N, 3) rays, N a multiple of 1024.

    org, d (N, 3) f32; offset (N,) int64 sample offsets; sky_colors the
    two colours of a background of mode 1 as a (2, 3) f32 tensor on the
    rays' device (MeshRenderer's buffer), which a miss sees as
    models.shirley.sky computes it, without sky()'s upload of the colours
    at every bounce (a CUDA graph cannot capture an upload); alive0 (N,)
    bool; hit_setup an Intersector of the scene and its mesh,
    hit_setup0 one that replaces it at bounce 0 (the tile-culled kernel of
    origin-zero primaries). Bounce b draws its two samples at dimensions
    2 + 2b and 3 + 2b. Returns (radiance (N, 3), segments: the live lanes
    summed over the bounces, a 0-dim int64 tensor on the device).

    On a CUDA device each bounce's pools' winner t and all its work after
    the mesh query are the kernels of ops/cuda/mesh_bounce_kernel.py
    (loaded there and nowhere else), over lanes updated in place; on the
    CPU it is trace_plain, their plain version, to the same radiance and
    segments. Each bounce counts
    pt.mesh_bounces, and pt.fused_bounces where the kernels ran it."""
    if org.device.type == "cpu":
        return trace_plain(sampler, org, d, offset, max_bounces, sky_colors,
                           alive0, hit_setup, hit_setup0)
    from .ops.cuda import mesh_bounce_kernel as mbk
    hit_setup0 = hit_setup if hit_setup0 is None else hit_setup0
    # the lanes' state, updated in place by mesh_bounce
    org, d, alive = org.clone(), d.clone(), alive0.clone()
    attn = torch.ones_like(org)
    rad = torch.zeros_like(org)
    segments = torch.zeros((), dtype=torch.int64, device=org.device)
    for bounce in range(max_bounces):
        with tracing.span("pt.bounce"):
            tracing.count("pt.lanes", org.shape[0])
            tracing.count("pt.mesh_bounces", 1)
            tracing.count("pt.fused_bounces", 1)
            hs = hit_setup0 if bounce == 0 else hit_setup
            with tracing.span("pt.intersect"):
                pools = hs.pools(org, d, alive)
                t_cur = mbk.winner_t(hs.scene, pools, org, d)
                hits = hs.query(org, d, t_cur, alive)
            with tracing.span("pt.scatter"):
                mbk.mesh_bounce(hs.scene, hs.mesh, pools, hits,
                                sampler.limbs(2 + 2 * bounce, 3 + 2 * bounce),
                                offset, sky_colors, org, d, attn, rad, alive,
                                segments)
    return rad, segments


def trace_plain(sampler: Sampler, org, d, offset, max_bounces: int,
                sky_colors, alive0, hit_setup, hit_setup0=None):
    """trace in eager PyTorch on any device: each bounce is hit_setup
    (pools, composite_hits), then scatter_bounce; the plain version of
    trace's kernel path, and trace itself on the CPU."""
    hit_setup0 = hit_setup if hit_setup0 is None else hit_setup0
    sky = tuple(c.expand_as(org) for c in sky_colors)
    alive = alive0
    attn = torch.ones_like(org)
    rad = torch.zeros_like(org)
    segments = torch.zeros((), dtype=torch.int64, device=org.device)
    for bounce in range(max_bounces):
        with tracing.span("pt.bounce"):
            tracing.count("pt.lanes", org.shape[0])
            tracing.count("pt.mesh_bounces", 1)
            segments += alive.sum()
            with tracing.span("pt.intersect"):
                h = (hit_setup0 if bounce == 0 else hit_setup)(org, d, alive)
            with tracing.span("pt.scatter"):
                org, d, attn, rad, alive = scatter_bounce(
                    h, sampler, bounce, offset, sky, org, d, attn, rad, alive)
    return rad, segments


def scatter_bounce(h, sampler: Sampler, bounce: int, offset, sky, org, d,
                   attn, rad, alive):
    """The end of one bounce of trace_plain, eager, after hit_setup's `h`:
    a live lane that misses adds attn times the sky (sky: the two colours
    expanded to (N, 3)) and dies; a hit scatters by its material with the
    bounce's two draws and moves the ray off the surface, or dies where
    the scatter ends the path. Returns the new (org, d, attn, rad, alive).
    The plain version of mesh_bounce's second half."""
    sky_lo, sky_hi = sky
    hit = h["hit"] & alive
    miss = alive & ~hit
    sky_d = vec.lerp(0.5 * (d[:, 1] + 1.0), sky_lo, sky_hi)
    rad = rad + vec.where3(miss, attn * sky_d, torch.zeros_like(rad))

    q = shading.shader_quat(h["normal"])
    omega_i = quat_ops.rotate(q, -d)
    u = sampler.get(offset, 2 + 2 * bounce)
    v = sampler.get(offset, 3 + 2 * bounce)
    wo, attn_mult, ok = shading.scatter(
        h["mat_kind"], h["albedo"], h["ior"], h["ior_inv"], omega_i,
        h["hit_front"], u, v)
    dir_world = quat_ops.rotate_inv(q, wo)
    new_org = shading.world_ray(h["point"], dir_world)

    alive = hit & ok
    org = vec.where3(alive, new_org, org)
    d = vec.where3(alive, dir_world, d)
    attn = vec.where3(alive, attn * attn_mult, attn)
    return org, d, attn, rad, alive


class MeshRenderer(_BandRenderer):
    """The path tracer over a scene with a triangle mesh (the path-traced
    ganesha): one `trace` per pass, the passes' radiance summed on the
    device, film reconstruction.

    Lanes are in raster order over the band's rows, lane = (y - y0) * W +
    x, padded to a multiple of 1024; lanes past the image are dead. The
    band is the tile rows [tile_row0, tile_row0 + band_tile_rows) (default:
    from tile_row0 to the image's last tile row; y0 = 32 * tile_row0), so
    the whole image has ceil(H/32)*32 rows. The JAX package orders its TPU
    lanes tile-major; the tile-culled kernel here reads and writes raster
    lanes (ops/cuda/tile_tri_kernel.py), so this layout needs no lane
    permutation around it, and each lane's result does not depend on the
    order or on the band. Bounce 0 meets the mesh through that kernel over
    a table built once per renderer with the path tracer's film map
    (flip_y=True), back-face culled when the mesh is watertight, and the
    band's maps of it (band_tile_maps); bounces >= 1 walk the mesh's BVH8
    table, or its BVH4 table past the BVH8 table's range. The composite
    intersectors of both (hit_setup0, hit_setup) are built once per
    renderer. On a BVH4 mesh forward zeroes the mesh's walk counters
    before an image and reads them with its segments in the closing
    pt.sync: pt.walk_rays, the rays the walks took, and on a card
    pt.walk_loads, their table loads."""

    def __init__(self, scene: Scene, camera: Camera, background, width: int,
                 height: int, spp: int, max_bounces: int, device, mesh,
                 tile_row0: int = 0, band_tile_rows: int | None = None):
        super().__init__(camera, background, width, height, spp,
                         max_bounces, tile_row0, band_tile_rows)
        self.scene, self.mesh = scene, mesh
        mode, sky_colors = background
        if mode != 1:
            raise ValueError(f"MeshRenderer: no sky of background mode {mode}")
        self.rows = rows = self.band * TILE
        lanes = -(-(rows * width) // 1024) * 1024
        self.tile_table = ttk.build_tile_tri_table(
            camera, mesh.tri_a, mesh.tri_e1, mesh.tri_e2, width, height,
            bvh=mesh, backface_cull=mesh.watertight, flip_y=True)
        lane = np.arange(lanes)
        y = tile_row0 * TILE + lane // width
        tile_start, tile_src = ttk.band_tile_maps(self.tile_table, tile_row0,
                                                  self.band)
        self._register(
            device, lane=(tile_row0 * TILE * width + lane).astype(np.int64),
            x=(lane % width).astype(np.float32), y=y.astype(np.float32),
            alive0=(lane < rows * width) & (y < height),
            tile=self.tile_table.table, tile_start=tile_start,
            tile_src=tile_src,
            sky_colors=np.asarray(sky_colors, np.float32),
            sums=np.zeros((lanes, 3), np.float32))
        tile = (self.tile, self.tile_start, self.tile_src)

        def mesh_intersect0(org, d, alive):
            """The tile-culled kernel over the raster band of whole tiles
            (ttk.intersect_band); org is unused (primaries start at the
            origin)."""
            return ttk.intersect_band(tile, d, alive, width, rows)

        # closures over tensors, not over the renderer: no reference cycle
        # keeps a dropped renderer, and its graph's pool, alive
        self.mesh_intersect0 = mesh_intersect0
        self.walk_counts = mesh.walk_counts
        self.hit_setup = Intersector(scene, mesh)
        self.hit_setup0 = Intersector(scene, mesh, mesh_intersect0)

    def primary(self, pass_idx):
        """Bounce-0 rays of one pass: (offset, org, d, alive), offset =
        y*W + x + pass*spp. pass_idx as _camera_rays'."""
        offset, d = self._camera_rays(self.lane, self.x, self.y, pass_idx)
        return offset, torch.zeros_like(d), d, self.alive0

    def trace_pass(self, pass_idx):
        """One sample per pixel: (radiance (lanes, 3) in raster order,
        segments tensor). pass_idx as primary's."""
        with tracing.span("pt.primary"):
            offset, org, d, alive = self.primary(pass_idx)
        return trace(self.sampler, org, d, offset, self.max_bounces,
                     self.sky_colors, alive, self.hit_setup, self.hit_setup0)

    def band_image(self, rad: torch.Tensor) -> torch.Tensor:
        """(lanes, 3) raster radiance -> the band's (band*32, W, 3) rows."""
        return rad[:self.rows * self.width].reshape(self.rows, self.width, 3)


def renderer_per_scene(camera: Camera, background, width: int, height: int,
                       spp: int, max_bounces: int, device,
                       fuse_bounce: bool = True, mesh=None, **band):
    """renderer(scene) -> the renderer of a scene object: a MeshRenderer of
    it and `mesh` when a mesh is given, else a Renderer (with fuse_bounce;
    band: its tile_row0 and band_tile_rows). It is built, in a
    `pt.renderer_init` span, at the first call with a scene object (its
    tables, tile lists or tile table, buffers; then at its first pass on a
    card the sphere hierarchy or the pass's CUDA graph) and kept while the
    same object comes again."""
    kept = [None, None]  # the scene last rendered and its renderer

    def renderer(scene: Scene):
        if kept[0] is not scene:
            args = (scene, camera, background, width, height, spp,
                    max_bounces, device)
            with tracing.span("pt.renderer_init"):
                kept[:] = scene, (MeshRenderer(*args, mesh, **band)
                                  if mesh is not None else
                                  Renderer(*args, fuse_bounce, **band))
        return kept[1]

    return renderer


def make_render_fn(camera: Camera, background, width: int, height: int,
                   spp: int, max_bounces: int, device,
                   fuse_bounce: bool = True, mesh=None):
    """render(scene, progress=None) -> (image (H, W, 3) f32 tensor on
    `device`, segments int). progress, if given, is called with the pixel
    count after each pass (the CLI's progress bar). fuse_bounce=False
    renders with the two-kernel bounce, to the same image: a parity path,
    not a tuning option. The kernels' wrappers run their plain PyTorch
    versions when `device` is the CPU. mesh: an ops.bvh.MeshBVH on
    `device` (models.ganesha.build_pt's); the render is then a
    MeshRenderer of the scene and the mesh (the JAX make_render_fn(...,
    mesh=mesh)), and fuse_bounce does not apply. Either renderer is kept
    per scene object (renderer_per_scene)."""
    renderer = renderer_per_scene(camera, background, width, height, spp,
                                  max_bounces, device, fuse_bounce, mesh)

    def render(scene: Scene, progress=None):
        with tracing.span(tracing.ROOT):
            return renderer(scene)(progress)

    return render
