"""Bounce-synchronous wavefront path tracer for sphere scenes.

Port of pathtracer_tpu/integrator.py: the tiled pass (make_pass_fn's
32x32-tile-major ray order), the kernel wavefront (_trace_pallas2), the
bounce-0 per-tile sphere lists (tile_sphere_lists, a numpy copy) and the
render driver (make_render_fn). Sampling follows the JAX package:

  - sampler dimension count D = 2 + 2*max_bounces
  - sample offset = y*W + x + pass*spp   (pass*spp, not pass*W*H)
  - dims (0, 1) jitter the pixel; dims (2+2i, 3+2i) drive bounce i
  - cx = (x+dx)/W, cy = 1-(y+dy)/H (flip_y)

The wavefront is the JAX kernel layout: state (10, rows, 128) f32 planes
[org3, dir3, attn3, alive], offsets (rows, 128) int32 (uint32 bit patterns)
and radiance (3, rows, 128). Every bounce is one fused_bounce kernel; lane
compaction runs at the _default_compact_at bounces.

Design choice, not a port of the JAX code: the JAX package pre-sizes
lax.switch buckets for the post-compaction wavefront because TPU shapes are
static. Here each compaction reads the live row count once on the host (one
sync per compaction) and runs the remaining bounces on that many rows,
rounded up to a multiple of 8 (one 1024-ray block). Rows past the live count
are dead after pack_rows, so the cut is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from . import film
from .camera import Camera
from .ops.cuda import compact_kernel as ck
from .ops.cuda import fused_bounce_kernel as fbk
from .ops.cuda.shade_kernel import pack_material_tables
from .ops.cuda.sphere_kernel import LANES, LIST_UNROLL, pack_spheres
from .ops.frustum import tile_frustum_planes
from .ops.lds import M32, Sampler
from .scene import Scene

__all__ = ["TILE", "tile_sphere_lists", "initial_state", "trace_wavefront",
           "Renderer", "make_render_fn"]

TILE = 32  # pixels per side of an image tile in tiled ray order


def _default_compact_at(max_bounces: int) -> tuple[int, ...]:
    """Compaction schedule of the JAX package (measured there): one
    compaction at bounce 3 for shallow renders, (2, 4) for deeper ones."""
    return (3,) if max_bounces <= 8 else (2, 4)


def tile_sphere_lists(camera, center, radius, valid, width, height):
    """Frustum-cull the sphere set per 32x32 image tile (host numpy, f64).

    Copy of the JAX integrator.tile_sphere_lists. Returns (lists (T, K)
    int32, counts (T, 1) int32): ascending global sphere indices per tile,
    counts padded to a multiple of LIST_UNROLL with duplicates of the first
    entry (a duplicate can never steal the strict-< minimum)."""
    center = np.asarray(center, np.float64)
    radius = np.asarray(radius, np.float64)
    valid = np.asarray(valid, bool)
    tyn = -(-height // TILE)
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


def trace_wavefront(sph_table, pack_table, state, off, sampler: Sampler,
                    max_bounces: int, background, *, origin_zero: bool,
                    block_lists0=None):
    """Trace the wavefront to completion (the JAX _trace_pallas2).

    sph_table (4, S); pack_table (10, Sq, 128); state (10, rows, 128);
    off (rows, 128) int32; background (bg_mode, colors); block_lists0:
    bounce-0 per-block sphere lists (tile-major rays only).
    Returns (radiance (3, rows, 128) in the input lane order, segments
    0-dim int64 tensor on the device)."""
    bg_mode, bg = background
    compact_at = {b for b in _default_compact_at(max_bounces)
                  if 0 < b < max_bounces}
    rows = state.shape[1]
    dev = state.device
    rad = torch.zeros(3, rows, LANES, dtype=torch.float32, device=dev)
    flush = torch.zeros(3, rows * LANES, dtype=torch.float32, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    chain = []
    for bounce in range(max_bounces):
        if bounce in compact_at:
            flush += _to_orig(rad, chain)
            alive_pre = state[9] > 0.0
            st_c, off_c, k = ck.compact_blocks(state, off)
            state, off, n_used = ck.pack_rows(st_c, off_c, k)
            chain.append((alive_pre.reshape(-1), ck.dest_map(alive_pre, k)))
            keep = -(-int(n_used) // 8) * 8  # the one host sync
            if keep == 0:
                return flush.reshape(3, rows, LANES), segments
            state = state[:, :keep].contiguous()
            off = off[:keep].contiguous()
            rad = torch.zeros(3, keep, LANES, dtype=torch.float32,
                              device=dev)
        segments += (state[9] > 0.0).sum()
        state, rad = fbk.fused_bounce(
            sph_table, state, pack_table, off,
            sampler.limbs(2 + 2 * bounce, 3 + 2 * bounce), bg, rad,
            bg_mode=bg_mode, origin_zero=origin_zero and bounce == 0,
            block_lists=block_lists0 if bounce == 0 else None)
    flush += _to_orig(rad, chain)
    return flush.reshape(3, rows, LANES), segments


class Renderer(torch.nn.Module):
    """The shirley-style path tracer over one sphere scene: the tiled pass
    loop, the kernel wavefront, film reconstruction. The scene tables, the
    tile-major ray order and the filter are buffers, so `.to(device)` moves
    them. forward(progress=None) -> (image (H, W, 3) f32 on the device,
    segments traced, int)."""

    def __init__(self, scene: Scene, camera: Camera, background, width: int,
                 height: int, spp: int, max_bounces: int, device):
        super().__init__()
        self.camera = camera
        self.background = background
        self.width, self.height = width, height
        self.spp, self.max_bounces = spp, max_bounces
        self.sampler = Sampler(2 + 2 * max_bounces)

        # 32x32-tile-major ray order: ray i of tile t is pixel
        # (ty*32 + i // 32, tx*32 + i % 32); edge tiles clamp and mask
        self.tyn, self.txn = -(-height // TILE), -(-width // TILE)
        ty, tx, iy, ix = np.meshgrid(np.arange(self.tyn), np.arange(self.txn),
                                     np.arange(TILE), np.arange(TILE),
                                     indexing="ij")
        y_ord = (ty * TILE + iy).reshape(-1)
        x_ord = (tx * TILE + ix).reshape(-1)
        valid = (y_ord < height) & (x_ord < width)
        y_c = np.minimum(y_ord, height - 1)
        x_c = np.minimum(x_ord, width - 1)
        lists, counts = tile_sphere_lists(
            camera, scene.center.cpu().numpy(), scene.radius.cpu().numpy(),
            scene.valid.cpu().numpy(), width, height)

        buf = lambda name, x: self.register_buffer(
            name, torch.as_tensor(x).to(device))
        buf("sph_table", pack_spheres(scene.center, scene.radius,
                                      scene.valid))
        buf("pack_table", pack_material_tables(scene.shade_pack))
        buf("lists", lists)
        buf("counts", counts)
        buf("pix", (y_c * width + x_c).astype(np.int64))
        buf("x_c", x_c.astype(np.float32))
        buf("y_c", y_c.astype(np.float32))
        buf("valid", valid)
        # the reconstruction filter of the JAX make_render_fn's defaults
        buf("kern2d", film.binomial_kernel_2d(order=5, pixel_radius=1)
            .astype(np.float32))

    def initial_wavefront(self, pass_idx: int):
        """Bounce-0 (state, off) of one pass in tile-major order."""
        offset = (self.pix + pass_idx * self.spp) & M32
        dx = self.sampler.get(offset, 0)
        dy = self.sampler.get(offset, 1)
        cx = (self.x_c + dx) * float(np.float32(1.0 / self.width))
        cy = 1.0 - (self.y_c + dy) * float(np.float32(1.0 / self.height))
        state = initial_state(self.camera.ray_dirs(cx, cy), self.valid)
        return state, offset.to(torch.int32).reshape(state.shape[1], LANES)

    def trace_pass(self, pass_idx: int):
        """One sample per pixel: (radiance planes (3, rows, 128) in tile-major
        order, segments tensor)."""
        state, off = self.initial_wavefront(pass_idx)
        return trace_wavefront(self.sph_table, self.pack_table, state, off,
                               self.sampler, self.max_bounces,
                               self.background, origin_zero=True,
                               block_lists0=(self.lists, self.counts))

    def untile(self, planes: torch.Tensor) -> torch.Tensor:
        """(3, rows, 128) tile-major radiance planes -> (H, W, 3)."""
        img = planes.reshape(3, -1).T.reshape(self.tyn, self.txn, TILE,
                                              TILE, 3)
        img = img.permute(0, 2, 1, 3, 4).reshape(self.tyn * TILE,
                                                 self.txn * TILE, 3)
        return img[:self.height, :self.width]

    @torch.no_grad()
    def forward(self, progress=None):
        sums = torch.zeros(3, self.pix.numel() // LANES, LANES,
                           dtype=torch.float32, device=self.pix.device)
        segments = torch.zeros((), dtype=torch.int64, device=self.pix.device)
        for p in range(self.spp):
            rad, segs = self.trace_pass(p)
            sums += rad
            segments += segs
            if progress is not None:
                progress(self.width * self.height)
        img = film.finalize(film.apply_filter(self.untile(sums), self.kern2d),
                            self.spp)
        return img, int(segments)


def make_render_fn(camera: Camera, background, width: int, height: int,
                   spp: int, max_bounces: int, device):
    """render(scene, progress=None) -> (image (H, W, 3) f32 tensor on
    `device`, segments int). progress, if given, is called with the pixel
    count after each pass (the CLI's progress bar). The kernels' wrappers
    run their plain PyTorch versions when `device` is the CPU."""

    def render(scene: Scene, progress=None):
        return Renderer(scene, camera, background, width, height, spp,
                        max_bounces, device)(progress)

    return render
