"""Progressive photon mapping, on one device or on a group of ranks.

Port of pathtracer_tpu/ppm.py's kernel tier: the lights and their photon
budgets, the photon pass (make_photon_pass), the eye pass with the chunk
gather (make_eye_pass with use_kernel=True) and the iteration loop
(PPMRenderer) with its multi-device modes (the JAX devices= and
shard_photon_map=; here a process group of ranks), for sphere and triangle
pools and an optional triangle mesh (ops.bvh.MeshBVH, the ganesha scene).
Each iteration runs

  1. the photon pass: emission, then max_bounces bounces of the composite
     intersector (integrator.Intersector; a mesh rides its BVH8 walk
     kernel) and the scatter, with a fixed deposit slot per (bounce, lane)
     and Russian roulette by the albedo's largest component; on a group of
     ranks each traces its own lane range;
  2. gather_kernel.build_photon_chunks over the deposits (all of them, or
     a rank's own: the sharded and ring maps);
  3. the eye pass over bands of image rows (one band on one device): the
     specular walk, recording each lane's first diffuse hit. In a mesh
     scene whose eye paths all end at their first hit, the mesh's eye rays
     go through the tile-culled triangle kernel
     (ops/cuda/tile_tri_kernel.py) instead of the walk, over bands of
     whole 32-row tile rows;
  4. the hit Morton sort and block_chunk_lists;
  5. the gather kernel, then `finish` (cone-filter normalizer 1 - 2/3, the
     disk area and 1/photon_count);
  6. the bands stitched, the film sum in float64 on the device, rows
     flipped to output order.

Sampling is the JAX package's, a pure function of (iteration, offset): the
photon sampler has D = 2 + 2*max_bounces and offsets lane +
iteration*photon_count; the eye sampler has D = 2 + max_bounces (one
dimension per eye bounce) and offsets pixel + iteration*W*H. So the photon
pass splits over lanes and the eye pass over bands with no change to any
sample, and checkpoint/resume is exact.
The radius schedule is r^2(i) = init * (1/i) * prod_{k<i} (k+alpha)/k with
init = ((bbox extent sum)/3 / ((W+H)/2))^2. The averaged image is written at
gamma 1/2.2 after every iteration.

Spans and counters (utils/tracing): each render() is one `ppm.render`
record, with `ppm.photons` (emission and bounces), `ppm.chunks`
(build_photon_chunks), eye_pass's `ppm.eye` (primaries, the walk or the
tile kernel) and `ppm.gather` (Morton sort, chunk gather, finish; the
sharded and ring maps run neither span), `ppm.film` (stitch and film sum)
and `ppm.sync` around each host read (the diffuse check at the start, the
chunk gather's item count, the verbose and output paths' reads, the
closing read). The counters `ppm.iters`, `ppm.deposit_rows`,
`ppm.deposits`, `ppm.photon_segments`, `ppm.eye_lanes` and `ppm.eye_hits`
are the iterations' sums; those kept on the device are added there and
read once, at the closing `ppm.sync`. On a group of ranks `ppm.deposits`
and `ppm.photon_segments` are the group's, the rest this rank's (the ring
counts no eye hits). With no group, `ppm.walk_lanes` counts on the host
the lanes the eye walk runs over, eye lanes x walk bounces an iteration,
and `ppm.walk_live` the lanes live as each walk bounce begins, summed over
the bounces: a device sum read at the closing `ppm.sync` where the walk
takes more than one bounce, else the image's pixels, known on the host
(the tile path's walk of one bounce adds no device operation). On a
card with no group the iterations after the first replay a CUDA graph of
the photon pass, chunk build and eye walk (graph.Replay): each replay is
one `ppm.replay` span in place of those stages' spans and counts
`ppm.graph_iters`, and the capture is one `ppm.capture` span.

Not ported: the XLA hash-grid gather (the plain chunk gather covers the
CPU), the eye-walk compaction ladder (specular mesh scenes only), the fused
single-chip iteration, phase_cb and the environment knobs of the JAX
renderer.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import List, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .camera import Camera
from .integrator import Intersector
from .io.png import write_png
from .ops import quat as quat_ops
from .ops import shading, vec
from .ops.cuda import gather_kernel as gk
from .ops.cuda import tile_tri_kernel as ttk
from .ops.cuda.sphere_kernel import BIG
from .ops.lds import M32, Sampler
from .parallel import group as G
from .parallel.ppm_ring import ring_eye_pass
from .scene import TRI_MAT, Scene
from .utils import tracing

__all__ = ["Light", "light_photon_counts", "photon_lanes", "rank_lane_range",
           "make_photon_pass", "scene_all_diffuse", "gather_hits",
           "make_eye_pass", "PPMRenderer"]

# the eye bands of a group's replicated and sharded maps, at any world
# size: JAX's multi-device band (pathtracer_tpu/ppm.py), so a group of n
# renders the bands of a group of one
GROUP_BAND_ROWS = 256

_SPOT_ANGLE = 0.5 * 45.0 * math.pi / 180.0
_SPOT_DISK_RADIUS = math.atan(_SPOT_ANGLE)  # as the reference writes it
_f32 = lambda x: float(np.float32(x))
_PI = _f32(np.pi)
_TWO_PI = _f32(2.0 * np.float32(np.pi))


@dataclass
class Light:
    kind: str  # "point" | "spot"
    position: np.ndarray  # camera space
    color: np.ndarray  # power-scaled color
    quat: np.ndarray = None  # spot: rotation of shader space (normal -> +z)

    @staticmethod
    def point(position, power, color=(1.0, 1.0, 1.0)) -> "Light":
        return Light("point", np.asarray(position, np.float64),
                     np.asarray(color, np.float64) * power)

    @staticmethod
    def spot(position, direction, power, color=(1.0, 1.0, 1.0)) -> "Light":
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        x, y, z = d  # the shader-space quaternion of d, host side
        if z > 1.0 - 1e-9:
            q = np.array([1.0, 0.0, 0.0, 0.0])
        elif z < 1e-9 - 1.0:
            q = np.array([0.0, 0.0, 1.0, 0.0])
        else:
            q = np.array([1.0 + z, y, -x, 0.0])
            q = q / np.linalg.norm(q)
        return Light("spot", np.asarray(position, np.float64),
                     np.asarray(color, np.float64) * power, q)

    @property
    def power(self) -> float:
        return float(self.color.sum())


def light_photon_counts(lights: List[Light], photon_count: int):
    """Per-light photon budgets, truncated: (counts, starts, total)."""
    total = sum(l.power for l in lights)
    counts, starts, off = [], [], 0
    for l in lights:
        c = int(photon_count * (l.power / total))
        starts.append(off)
        counts.append(c)
        off += c
    return counts, starts, off


def _emitters(lights, counts, starts, dev):
    """Each light with its lane range and its constants on the device:
    (light, count, start, position, quat or None, colour), made once per
    photon pass, so that emission uploads nothing (a CUDA graph cannot
    capture an upload)."""
    const = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return [(l, c, s, const(l.position),
             None if l.quat is None else const(l.quat), const(l.color))
            for l, c, s in zip(lights, counts, starts)]


def _emit_rays(emitters, lane_ids, u, v):
    """Light emission per lane, the light picked by the lane's index range
    (emitters from _emitters). Returns (org, d, flux), each (n, 3) f32."""
    n = lane_ids.shape[0]
    dev = u.device
    org = torch.zeros(n, 3, device=dev)
    d = torch.zeros(n, 3, device=dev)
    flux = torch.zeros(n, 3, device=dev)
    for l, c, s, pos, quat, color in emitters:
        mask = (lane_ids >= s) & (lane_ids < s + c)
        if l.kind == "point":  # uniform sphere
            theta = _TWO_PI * u
            phi = torch.acos(1.0 - 2.0 * v)
            sp = torch.sin(phi)
            dl = vec.v3(sp * torch.cos(theta), sp * torch.sin(theta),
                        torch.cos(phi))
            ol = pos.expand(n, 3)
        else:  # spot: disk-cone through the shader-space world ray
            r = _f32(_SPOT_DISK_RADIUS) * vec.sqrt(u)
            theta = v * 2.0 * _PI
            local = vec.v3(r * torch.cos(theta), r * torch.sin(theta),
                           torch.ones_like(u))
            dl = quat_ops.rotate_inv(quat.expand(n, 4), local)
            ol = pos + _f32(1e-3) * dl
        org = vec.where3(mask, ol, org)
        d = vec.where3(mask, dl, d)
        flux = vec.where3(mask, color.expand(n, 3), flux)
    return org, d, flux


def photon_lanes(lights, photon_count: int) -> int:
    """The photon pass's lane count: the traced photons rounded up to a
    multiple of 1024."""
    return -(-light_photon_counts(lights, photon_count)[2] // 1024) * 1024


def rank_lane_range(lanes: int, n: int, rank: int):
    """Rank `rank`'s lanes [lo, hi) of n ranks: the JAX package's chunk
    `rank` (make_photon_pass with n devices: ceil(lanes/n) rounded up to
    1024 lanes a chunk), one chunk per rank; a range past `lanes` holds
    only dead lanes. The JAX package also caps a chunk at 131,072 lanes (a
    bound on one TPU call's duration); a rank here traces its one range."""
    per = -(-lanes // n)
    chunk = -(-per // 1024) * 1024
    return rank * chunk, (rank + 1) * chunk


def make_photon_pass(scene: Scene, lights, photon_count: int,
                     max_bounces: int, mesh=None, lane_range=None):
    """Build trace_photons(offset_base) -> (pos, nrm, flux, valid,
    segments): deposits of shape (lanes * max_bounces, .) in (bounce, lane)
    order, and the ray segments traced (a 0-dim tensor); offset_base is an
    int or a 0-dim int64 tensor on the scene's device (a CUDA graph's
    input), to the same samples;
    trace_photons.deposits(offset_base) gives the same deposits in
    (max_bounces, lanes, .) form, before the flatten (deposits of lane
    ranges concatenate along that lane axis to the whole trace's), and
    trace_photons.emit(offset_base) the bounce-0 rays. mesh: an optional
    ops.bvh.MeshBVH beside the scene's pools. lane_range: trace lanes
    [lo, hi) only (multiples of 1024; default all), with each lane's
    sample offsets those of the whole trace. Returns (trace_photons,
    photons traced, deposit rows)."""
    sampler = Sampler(2 + 2 * max_bounces)
    counts, starts, total = light_photon_counts(lights, photon_count)
    lo, hi = lane_range or (0, photon_lanes(lights, photon_count))
    if lo % 1024 or hi % 1024 or hi < lo:
        raise ValueError(f"make_photon_pass: lane range [{lo}, {hi}) is "
                         "not of whole 1024-lane blocks")
    dev = scene.center.device
    lane_ids = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    hit_setup = Intersector(scene, mesh)
    emitters = _emitters(lights, counts, starts, dev)

    def emit(offset_base):
        """Bounce-0 photon rays: (offs, org, d, flux, alive)."""
        offs = (lane_ids + offset_base) & M32
        org, d, flux = _emit_rays(emitters, lane_ids, sampler.get(offs, 0),
                                  sampler.get(offs, 1))
        return offs, org, d, flux, lane_ids < total

    def deposits(offset_base):
        offs, org, d, flux, alive = emit(offset_base)
        segments = torch.zeros((), dtype=torch.int64, device=dev)
        deps = []
        for b in range(max_bounces):
            segments += alive.sum()
            u = sampler.get(offs, 2 + 2 * b)
            v = sampler.get(offs, 3 + 2 * b)
            h = hit_setup(org, d, alive)
            hit = h["hit"] & alive
            q = shading.shader_quat(h["normal"])
            omega_i = quat_ops.rotate(q, -d)
            albedo = h["albedo"]
            is_diff = h["mat_kind"] == 0
            is_met = h["mat_kind"] == 1

            # diffuse deposit (the flux takes the albedo first)
            f_dep = flux * albedo
            deps.append((h["point"], h["normal"], f_dep, hit & is_diff))

            wo_met, met_ok, tint, wo_die = shading.specular(
                albedo, h["ior"], h["ior_inv"], omega_i, h["hit_front"], u)
            # diffuse Russian roulette
            cmax = torch.amax(albedo, dim=-1)
            rr = u <= cmax
            cm_inv = 1.0 / cmax
            wo_dif = shading.cosine_hemisphere(u * cm_inv, v)
            f_dif = f_dep * cm_inv[:, None]

            wo = vec.where3(is_diff, wo_dif,
                            vec.where3(is_met, wo_met, wo_die))
            f_new = vec.where3(is_diff, f_dif,
                               vec.where3(is_met, flux * tint, flux))
            ok = torch.where(is_diff, rr, torch.where(is_met, met_ok, True))

            dir_world = quat_ops.rotate_inv(q, wo)
            new_org = shading.world_ray(h["point"], dir_world)
            alive = hit & ok
            org = vec.where3(alive, new_org, org)
            d = vec.where3(alive, dir_world, d)
            flux = vec.where3(alive, f_new, flux)
        pos, nrm, fl, valid = (torch.stack(x) for x in zip(*deps))
        return pos, nrm, fl, valid, segments

    def trace_photons(offset_base):
        pos, nrm, fl, valid, segments = deposits(offset_base)
        return (pos.reshape(-1, 3), nrm.reshape(-1, 3), fl.reshape(-1, 3),
                valid.reshape(-1), segments)

    trace_photons.emit, trace_photons.deposits = emit, deposits
    return trace_photons, total, (hi - lo) * max_bounces


def _build_grid_morton_device(pos, nrm, flux, ok, r):
    """The raster gather's photon grid, built on the device with no host
    read (the JAX function of the same name): the grid origin is the valid
    deposits' low corner moved down by 1e-5 + 1e-6 |lo| (so every valid
    deposit lands at a cell index >= 0), the cell max(r, extent / 127), all
    in float32. Returns (photons_t, start, count) of
    gather_kernel.build_photon_grid_morton, the origin (3,) and the cell
    (a 0-dim tensor). No renderer calls it: the photon mapper gathers over
    photon chunks."""
    dev = pos.device
    f32 = lambda x: torch.tensor(np.float32(x), device=dev)
    okm = ok[:, None]
    glo = torch.amin(torch.where(okm, pos, BIG), dim=0)
    ghi = torch.amax(torch.where(okm, pos, -BIG), dim=0)
    glo = glo - (f32(1e-5) + f32(1e-6) * torch.abs(glo))
    extent = torch.clamp(torch.amax(ghi - glo), min=_f32(1e-9))
    cell = torch.maximum(f32(r), extent / f32(gk.SIDE - 1))
    photons_t, start, count = gk.build_photon_grid_morton(pos, nrm, flux, ok,
                                                          glo, cell)
    return photons_t, start, count, glo, cell


def scene_all_diffuse(scene: Scene, mesh=None) -> bool:
    """True when no valid primitive (nor the mesh) has a specular
    (metal/dielectric) material: then every eye path ends at its first
    hit."""
    if bool((scene.mat_kind[scene.valid] != 0).any()):
        return False
    if scene.tri_count:
        mk = scene.tri_pack[scene.tri_valid][:, TRI_MAT.start]
        if bool((mk != 0).any()):
            return False
    return mesh is None or float(mesh.mat_row[0]) == 0.0


def gather_hits(point, normal, active, radius: float, grid):
    """The photon flux at eye hits (n, 3), n % 1024 == 0: Morton-sort the
    hits, gather_flux_chunks over grid = (photons_t, sbox), unsort."""
    photons_t, sbox = grid
    perm = torch.argsort(gk.hit_morton_keys(point, active), stable=True)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(perm.shape[0], device=point.device)
    flux = gk.gather_flux_chunks(point[perm], normal[perm], active[perm],
                                 sbox, photons_t, radius)
    return flux[inv_perm]


def make_eye_pass(camera: Camera, width: int, height: int,
                  max_bounces: int, photon_count: int, scene: Scene,
                  eff_bounces: int = None, mesh=None, tile=None,
                  band_rows: int = None, row0: int = 0):
    """Build eye_pass(offset_base, radius: float, grid, hits=None) ->
    the iteration's image contribution of the band of image rows [row0,
    row0 + band_rows) that lie in the image, (rows, W, 3) f32, rows in
    camera order (not flipped), scaled by 1/photon_count; grid = (photons_t,
    sbox) from build_photon_chunks; hits, where given, a list that gets the
    band's eye hits (a 0-dim device tensor). The band is
    ceil(W*band_rows/1024)*1024 lanes (lane = (y - row0)*W + x, sample
    offset y*W + x); its lanes past the image are dead. band_rows defaults
    to the whole image: H, or ceil(H/32)*32 with the tile kernel.
    offset_base is an int or a 0-dim int64 tensor on the scene's device (a
    CUDA graph's input), to the same samples.

    eff_bounces caps the specular walk: in a scene with no specular
    material every eye path ends at its first hit; the sampler keeps
    max_bounces dimensions either way. mesh: an optional ops.bvh.MeshBVH.
    tile: the band's (table, tile_chunk_start, tile_chunk_src) tensors
    (TileTriTable.tensors for the whole image, band_tile_maps for a band),
    allowed only when eff_bounces is 1 and the band is of whole 32-row
    tile rows: the eye rays then meet the mesh through intersect_tile_tris
    instead of the walk. eye_pass.primary, .walk, .gather and .finish are
    the stages, for tests, measurement and the sharded photon maps;
    eye_pass.walk_counted is the walk with its live lanes counted (the
    iteration graph's); eye_pass.shade(walked, radius, grid) is the part
    after the walk (the gather and finish of walk's output)."""
    sampler = Sampler(2 + max_bounces)
    eff_bounces = max_bounces if eff_bounces is None else eff_bounces
    if band_rows is None:
        band_rows = (height if tile is None
                     else -(-height // ttk.TILE) * ttk.TILE)
    rows = band_rows
    mesh_intersect = None
    if tile is not None:
        if mesh is None or eff_bounces != 1:
            raise ValueError("make_eye_pass: the tile lists need a mesh and "
                             "hold only for origin-zero primaries "
                             "(eff_bounces == 1)")
        if rows % ttk.TILE or row0 % ttk.TILE:
            raise ValueError(f"make_eye_pass: the tile kernel takes bands of "
                             f"whole tile rows; got rows [{row0}, "
                             f"{row0 + rows})")

        def mesh_intersect(org, d, alive_m):
            # primaries start at the origin, so org is unused
            return ttk.intersect_band(tile, d, alive_m, width, rows)

    n_out = max(0, min(rows, height - row0))  # the band's rows in the image
    lanes = -(-(width * rows) // 1024) * 1024
    dev = scene.center.device
    lane_ids = torch.arange(lanes, dtype=torch.int64, device=dev)
    pix = row0 * width + lane_ids
    xs = (lane_ids % width).to(torch.float32)
    ys = (pix // width).to(torch.float32)
    alive0 = (lane_ids < width * n_out)
    inv_w, inv_h = _f32(1.0 / width), _f32(1.0 / height)
    inv_pc = _f32(1.0 / photon_count)
    normalizer = np.float32(1.0 - 2.0 / 3.0)
    hit_setup = Intersector(scene, mesh, mesh_intersect)

    def primary(offset_base):
        """Bounce-0 eye rays: (offs, org, d, alive). Eye rays are not
        flipped; the image is."""
        offs = (pix + offset_base) & M32
        cx = (xs + sampler.get(offs, 0)) * inv_w
        cy = (ys + sampler.get(offs, 1)) * inv_h
        d = camera.ray_dirs(cx, cy)
        return offs, torch.zeros_like(d), d, alive0

    def walk_counted(offset_base):
        """The specular walk: (fd_pt, fd_nrm, fd_beta, fd_ok), each lane's
        first diffuse hit, and the lanes live as each bounce begins, summed
        over the bounces: a 0-dim int64 tensor, or None for a walk of one
        bounce, whose live lanes are the band's pixels."""
        offs, org, d, alive = primary(offset_base)
        beta = torch.ones_like(d)
        fd_pt = torch.zeros_like(d)
        fd_nrm = torch.zeros_like(d)
        fd_beta = torch.zeros_like(d)
        fd_ok = torch.zeros_like(alive0)
        live = None
        for b in range(eff_bounces):
            if eff_bounces > 1:
                live = alive.sum() if live is None else live + alive.sum()
            u = sampler.get(offs, 2 + b)  # one dimension per eye bounce
            h = hit_setup(org, d, alive)
            hit = h["hit"] & alive
            q = shading.shader_quat(h["normal"])
            omega_i = quat_ops.rotate(q, -d)
            albedo = h["albedo"]
            is_diff = h["mat_kind"] == 0
            is_met = h["mat_kind"] == 1

            # diffuse: record and stop (a lane gets here at most once)
            take = hit & is_diff
            fd_pt = vec.where3(take, h["point"], fd_pt)
            fd_nrm = vec.where3(take, h["normal"], fd_nrm)
            fd_beta = vec.where3(take, beta * albedo, fd_beta)
            fd_ok = fd_ok | take

            # specular continuation
            wo_met, met_ok, tint, wo_die = shading.specular(
                albedo, h["ior"], h["ior_inv"], omega_i, h["hit_front"], u)
            wo = vec.where3(is_met, wo_met, wo_die)
            beta_new = vec.where3(is_met, beta * tint, beta)
            ok = torch.where(is_met, met_ok, ~is_diff)

            dir_world = quat_ops.rotate_inv(q, wo)
            new_org = shading.world_ray(h["point"], dir_world)
            alive = hit & ok
            org = vec.where3(alive, new_org, org)
            d = vec.where3(alive, dir_world, d)
            beta = vec.where3(alive, beta_new, beta)
        return fd_pt, fd_nrm, fd_beta, fd_ok, live

    def walk(offset_base):
        """walk_counted's first diffuse hits, without the count."""
        return walk_counted(offset_base)[:4]

    def finish(fd_beta, fd_ok, flux, radius: float):
        r = np.float32(radius)
        # a device tensor, so the division is elementwise on every device
        # (torch on CUDA multiplies by the reciprocal of a host scalar)
        denom = torch.tensor(np.float32(np.pi) * r * r * normalizer,
                             device=dev)
        contrib = fd_beta * flux / denom
        result = vec.where3(fd_ok, contrib, torch.zeros_like(contrib))
        return (result * inv_pc)[:n_out * width].reshape(n_out, width, 3)

    def shade(walked, radius: float, grid):
        fd_pt, fd_nrm, fd_beta, fd_ok = walked
        with tracing.span("ppm.gather"):
            flux = gather_hits(fd_pt, fd_nrm, fd_ok, radius, grid)
            return finish(fd_beta, fd_ok, flux, radius)

    def eye_pass(offset_base, radius: float, grid, hits=None):
        with tracing.span("ppm.eye"):
            walked = walk(offset_base)
        if hits is not None:
            hits.append(walked[3].sum())
        return shade(walked, radius, grid)

    eye_pass.primary, eye_pass.walk = primary, walk
    eye_pass.walk_counted = walk_counted
    eye_pass.gather, eye_pass.finish = gather_hits, finish
    eye_pass.shade = shade
    return eye_pass


def _fresh(out):
    """The prefix's outputs with each 0-dim tensor copied, so no kept
    result aliases memory that the next replay writes."""
    if isinstance(out, torch.Tensor):
        return out.clone() if out.dim() == 0 else out
    if out is None:
        return None
    return type(out)(_fresh(x) for x in out)


def _flat(deposits):
    """(pos, nrm, flux, valid) deposits of any leading shape, as
    build_photon_chunks takes them: (N, 3) and (N,)."""
    return (x.reshape(-1, 3) if x.dim() == 3 else x.reshape(-1)
            for x in deposits)


class _Passes(NamedTuple):
    """A render's passes: the photon pass (make_photon_pass), this rank's
    deposit rows an iteration, the eye passes of this rank's bands (band ->
    make_eye_pass), and the band rows and count."""

    trace_photons: object
    deposit_rows: int
    eyes: dict
    rows: int
    n_bands: int

    def prefix(self, photon_offset, eye_offset):
        """One process's iteration up to the chunk gather, which reads
        nothing on the host: the photon pass and the map's length, the
        chunk build and each band's walk with its eye hits. The offsets are
        ints or 0-dim int64 tensors on the device (a CUDA graph's inputs).
        Returns (photon segments, map length, grid, walks: per band
        (fd_pt, fd_nrm, fd_beta, fd_ok, eye hits, live lanes or None:
        make_eye_pass's walk_counted))."""
        with tracing.span("ppm.photons"):
            deps = self.trace_photons.deposits(photon_offset)
            segments, n_photons = deps[4], deps[3].sum()
        with tracing.span("ppm.chunks"):
            grid = gk.build_photon_chunks(*_flat(deps[:4]))
        walks = []
        for eye in self.eyes.values():
            with tracing.span("ppm.eye"):
                walked = eye.walk_counted(eye_offset)
            walks.append(walked[:4] + (walked[3].sum(), walked[4]))
        return segments, n_photons, grid, walks


@dataclass
class PPMRenderer:
    """The iteration loop. render() returns the sum of the iterations'
    images, (H, W, 3) float64 on the scene's device; divide by the
    iteration count for the averaged linear image.

    mesh: an optional ops.bvh.MeshBVH beside the scene's pools (ganesha);
    the initial radius then comes from the mesh's box instead of the
    scene's. tile_primary: the eye rays meet the mesh through the
    tile-culled kernel whenever there is a mesh and every eye path ends at
    its first hit (True, on every device), or through the walk (False).
    The tile table is built once per renderer, back-face culled when the
    mesh is watertight.

    group: the ProcessGroup of the ranks that render together, each with
    this renderer on its own device (parallel.ppm_ring.make_ppm_mesh's
    "pp" dimension), or None for this process alone. Rank k of n traces
    the photon lanes rank_lane_range(lanes, n, k), and the image is cut
    into bands: GROUP_BAND_ROWS rows (at most H, rounded up to 32 with the
    tile kernel) whatever n is, as the JAX package's are; without a group
    the band is the whole image. shard_photon_map picks the photon map:
      False  - replicated: the deposits are all-gathered along the lane
               axis (the one-device trace's order) and every rank builds
               the same grid; band b runs on rank b % n. Equal to a group
               of one's render, bit for bit, at any n (the chunk gather's
               blocks are of one band's hits, so other bands, as one
               process's whole-image band, regroup its sums);
      True   - each rank builds a sub-grid over its own deposits; the walk
               records of every band are all-gathered, every rank gathers
               a partial flux against its sub-grid, and a band's owner
               adds the partials in rank order 0..n-1;
      "ring" - one band of ceil(H/n) rows (rounded up to 32 with the tile
               kernel) per rank, the last ones all dead when the image has
               fewer, the sub-grids passed round the ring
               (parallel/ppm_ring.py).
    True and "ring" agree with the replicated map up to the flux sum's
    association. Every rank returns the same image sum, photon map lengths
    and segments (the group's); rank 0 alone prints, writes the PNG and
    the checkpoint, and every rank reads the checkpoint.

    On a CUDA device with no group, each iteration's prefix (the photon
    pass, the chunk build and the eye walk: _Passes.prefix) is a CUDA graph
    (graph.Replay, loaded there and nowhere else): the renderer's
    first iteration runs eagerly, as the warm-up before the capture, every
    later one, in this render and the later ones, is a replay, to the same
    image bit for bit. A change to a field that the graph's shapes or
    constants come from (the scene, camera, mesh and lights, width,
    height, photon_count, max_bounces, tile_primary, and the walk's depth)
    captures anew. On the CPU and on a group the iterations run eagerly."""

    scene: Scene
    camera: Camera
    lights: List[Light]
    width: int
    height: int
    iterations: int = 10
    photon_count: int = 75000
    alpha: float = 2.0 / 3.0
    max_bounces: int = 4
    verbose: bool = True
    mesh: object = None
    tile_primary: bool = True
    group: object = None
    shard_photon_map: object = False

    def __post_init__(self):
        self.tile_table = self._tile = None
        self._graph = None  # (key, passes, Replay), made on a card
        if self.shard_photon_map not in (False, True, "ring"):
            raise ValueError(f"shard_photon_map: False, True or 'ring', not "
                             f"{self.shard_photon_map!r}")
        if self.mesh is not None:
            lo = self.mesh.bbox_lo.astype(np.float64)
            hi = self.mesh.bbox_hi.astype(np.float64)
        else:
            lo, hi = self.scene.bbox()
        a = float((hi - lo).sum()) / 3.0
        b = (self.width + self.height) / 2.0
        self.init_radius2 = (a / b) ** 2

    def tile_tensors(self, eff_bounces: int):
        """The tile table's tensors on the scene's device when the eye
        pass uses the tile kernel, else None; built on the first call."""
        use = self.tile_primary and self.mesh is not None and eff_bounces == 1
        if use and self._tile is None:
            self.tile_table = ttk.build_tile_tri_table(
                self.camera, self.mesh.tri_a, self.mesh.tri_e1,
                self.mesh.tri_e2, self.width, self.height, bvh=self.mesh,
                backface_cull=self.mesh.watertight)
            self._tile = self.tile_table.tensors(self.scene.center.device)
        return self._tile if use else None

    def radius(self, i: int) -> float:
        """The gather radius of iteration i (1-based)."""
        assert i >= 1
        product = 1.0
        for k in range(1, i):
            product *= (k + self.alpha) / k
        return math.sqrt(product * self.init_radius2 / i)

    def _bands(self, n, tiled: bool):
        """(band rows, band count) of a group of n ranks, or of this
        process alone (n None): the whole image."""
        ring = n is not None and self.shard_photon_map == "ring"
        rows = (self.height if n is None else -(-self.height // n) if ring
                else min(GROUP_BAND_ROWS, self.height))
        if tiled:
            rows = -(-rows // ttk.TILE) * ttk.TILE
        return rows, n if ring else -(-self.height // rows)

    def _passes(self, eff_bounces: int, n: int | None, k: int) -> _Passes:
        """Rank k of n's passes (n None: this process alone)."""
        lanes = photon_lanes(self.lights, self.photon_count)
        trace_photons, _, deposit_rows = make_photon_pass(
            self.scene, self.lights, self.photon_count, self.max_bounces,
            self.mesh, lane_range=rank_lane_range(lanes, n or 1, k))
        tile = self.tile_tensors(eff_bounces)
        rows, n_bands = self._bands(n, tile is not None)
        eyes = {b: self._eye_pass(eff_bounces, tile, rows, b)
                for b in range(k, n_bands, n or 1)}
        return _Passes(trace_photons, deposit_rows, eyes, rows, n_bands)

    def _iteration_graph(self, eff_bounces: int):
        """(passes, prefix): this renderer's _Passes and their prefix as a
        CUDA graph (graph.Replay), made anew when a field that its shapes or
        constants come from has changed. prefix returns the 0-dim outputs
        as copies, the rest as the graph's static outputs. The kept passes
        hold the scene, camera and mesh, so their ids stay theirs while the
        graph lives."""
        key = (id(self.scene), id(self.camera), id(self.mesh), self.width,
               self.height, self.photon_count, self.max_bounces,
               self.tile_primary, eff_bounces,
               tuple((l.kind, l.position.tobytes(), l.color.tobytes(),
                      None if l.quat is None else l.quat.tobytes())
                     for l in self.lights))
        if self._graph is None or self._graph[0] != key:
            from .graph import Replay
            self._graph = None  # the old graph's pool goes first
            self._graph = (key, self._passes(eff_bounces, None, 0),
                           Replay(_Passes.prefix, 2, self.scene.center.device,
                                  "ppm", "ppm.graph_iters"))
        _, passes, replay = self._graph
        return passes, lambda *offsets: _fresh(replay(passes, *offsets))

    def _eye_pass(self, eff_bounces: int, tile, rows: int, band: int):
        """make_eye_pass over band `band` of `rows` rows, with the band's
        maps of the tile table when the tile kernel runs."""
        if tile is not None:
            tile = (tile[0],) + tuple(
                torch.as_tensor(x, device=tile[0].device)
                for x in ttk.band_tile_maps(self.tile_table,
                                            band * rows // ttk.TILE,
                                            rows // ttk.TILE))
        return make_eye_pass(self.camera, self.width, self.height,
                             self.max_bounces, self.photon_count, self.scene,
                             eff_bounces, self.mesh, tile, band_rows=rows,
                             row0=band * rows)

    @torch.no_grad()
    def render(self, output: str = None, checkpoint_cb=None,
               checkpoint_path: str = None):
        """Run the iterations. output: PNG path, rewritten after every
        iteration with the averaged image at gamma 1/2.2. checkpoint_path:
        (img_sum, next_iteration) are saved there every iteration, and the
        run resumes from that file when it exists. checkpoint_cb(i,
        img_sum) is called after each iteration.

        Afterwards self.iter_segments holds, per iteration, (photon ray
        segments as a 0-dim device tensor, eye segments or None: exact only
        when every eye path ends at its first hit), self.photon_map_lengths
        the valid deposits (0-dim device tensors), and self.deposit_rows
        this rank's deposit rows per iteration. The render is one
        `ppm.render` record of utils.tracing."""
        with tracing.span(tracing.PPM_ROOT):
            return self._render(output, checkpoint_cb, checkpoint_path)

    def _render(self, output, checkpoint_cb, checkpoint_path):
        group = self.group
        n = 1 if group is None else dist.get_world_size(group)
        k = 0 if group is None else dist.get_rank(group)
        lead = k == 0
        verbose = self.verbose and lead
        if verbose:
            print(f"#max-bounces = {self.max_bounces}")
            print(f"#photons/iter = {self.photon_count}")
            print(f"#iterations = {self.iterations}")
            print("-----", flush=True)
        with tracing.span("ppm.sync"):
            eff_bounces = (1 if scene_all_diffuse(self.scene, self.mesh)
                           else self.max_bounces)
        dev = self.scene.center.device
        if group is None and dev.type == "cuda":
            passes, prefix = self._iteration_graph(eff_bounces)
        else:
            passes = self._passes(eff_bounces, None if group is None else n,
                                  k)
            prefix = passes.prefix
        trace_photons, self.deposit_rows, eyes, rows, n_bands = passes
        mine = list(eyes)
        eye_lanes = len(mine) * (-(-(self.width * rows) // 1024) * 1024)
        lanes = photon_lanes(self.lights, self.photon_count)
        # one process alone: every map is the replicated one
        mode = self.shard_photon_map if group is not None else False
        img_sum = torch.zeros(self.height, self.width, 3,
                              dtype=torch.float64, device=dev)
        start_iter = 0
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            ck = np.load(checkpoint_path)
            if (ck["img_sum"].shape == tuple(img_sum.shape)
                    and int(ck["photon_count"]) == self.photon_count
                    and float(ck["alpha"]) == self.alpha):
                img_sum = torch.as_tensor(ck["img_sum"], device=dev)
                start_iter = int(ck["next_iteration"])
                if verbose:
                    print(f"resuming from iteration {start_iter}", flush=True)

        self.iter_segments = []
        self.photon_map_lengths = []
        hits = []  # the eye hits of each band and iteration (device)
        live = []  # the walk's live lanes of each band and iteration (device)
        for i in range(start_iter, self.iterations):
            t_iter = time.monotonic()
            r = self.radius(i + 1)
            if verbose:
                print(f"#iteration = {i}, radius = {r:.3f}", flush=True)
            photon_offset = i * self.photon_count & M32
            offset = i * self.width * self.height & M32
            if group is None:
                segments, n_photons, grid, walks = prefix(photon_offset,
                                                          offset)
            else:
                with tracing.span("ppm.photons"):
                    deps = trace_photons.deposits(photon_offset)
                    segments, n_photons = deps[4], deps[3].sum()
                    G.all_reduce_sum(segments, group)
                    G.all_reduce_sum(n_photons, group)
            tracing.count("ppm.iters", 1)
            tracing.count("ppm.deposit_rows", self.deposit_rows)
            if verbose:
                with tracing.span("ppm.sync"):
                    length = int(n_photons)
                print(f"  photon map length = {length} "
                      f"({time.monotonic() - t_iter:.2f}s)", flush=True)
            if group is not None:
                with tracing.span("ppm.chunks"):
                    if mode is False:
                        # the whole trace's deposits: every rank's lanes in
                        # order
                        deps = [G.all_gather_rows(x.transpose(0, 1), group)
                                .transpose(0, 1)[:, :lanes]
                                for x in deps[:4]]
                    grid = gk.build_photon_chunks(*_flat(deps[:4]))
            tracing.count("ppm.eye_lanes", eye_lanes)
            if group is None:
                bands = [eyes[b].shade(w[:4], r, grid)
                         for b, w in zip(mine, walks)]
                hits.extend(w[4] for w in walks)
                tracing.count("ppm.walk_lanes", eye_lanes * eff_bounces)
                if eff_bounces == 1:
                    tracing.count("ppm.walk_live", self.width * self.height)
                else:
                    live.extend(w[5] for w in walks)
            elif mode is False:
                bands = [eyes[b](offset, r, grid, hits) for b in mine]
            elif mode == "ring":
                bands = [ring_eye_pass(eyes[k], offset, r, grid, group)]
            else:
                bands = self._sharded_bands(eyes, mine, n_bands, rows, offset,
                                            r, grid, hits)
            with tracing.span("ppm.film"):
                img = self._stitch(bands, n_bands, rows)
                img_sum += img.flip(0).to(torch.float64)  # output row order
            if verbose:
                if dev.type == "cuda":
                    with tracing.span("ppm.sync"):
                        torch.cuda.synchronize(dev)
                print(f"  iteration wall = "
                      f"{time.monotonic() - t_iter:.2f}s", flush=True)
            if output is not None and lead:
                with tracing.span("ppm.sync"):
                    avg = ((img_sum / (i + 1)) ** (1.0 / 2.2)).cpu().numpy()
                write_png(output, avg)  # PPM gamma 1/2.2
            if checkpoint_path is not None and lead:
                with tracing.span("ppm.sync"):
                    host_sum = img_sum.cpu().numpy()
                tmp = checkpoint_path + ".tmp.npz"
                np.savez(tmp, img_sum=host_sum, next_iteration=i + 1,
                         photon_count=self.photon_count, alpha=self.alpha)
                os.replace(tmp, checkpoint_path)
            self.iter_segments.append(
                (segments,
                 self.width * self.height if eff_bounces == 1 else None))
            self.photon_map_lengths.append(n_photons)
            if checkpoint_cb is not None:
                checkpoint_cb(i, img_sum)
        self._count_totals(hits, live)
        return img_sum

    def _count_totals(self, hits, live) -> None:
        """The closing read: the iterations' deposits, photon segments, eye
        hits and the walk's live lanes, each summed on the device, read in
        one ppm.sync."""
        parts = [("ppm.deposits", self.photon_map_lengths),
                 ("ppm.photon_segments", [s for s, _ in self.iter_segments]),
                 ("ppm.eye_hits", hits), ("ppm.walk_live", live)]
        sums = [(name, torch.stack(x).sum()) for name, x in parts if x]
        if not sums:
            return
        with tracing.span("ppm.sync"):
            totals = torch.stack([x for _, x in sums]).tolist()
        for (name, _), total in zip(sums, totals):
            tracing.count(name, total)

    def _stitch(self, bands, n_bands: int, rows: int):
        """The image (H, W, 3) in camera row order from this rank's bands
        (its bands b = k, k + n, ...), all-gathered over the group."""
        group = self.group
        mine = (torch.cat(bands) if bands else torch.zeros(
            0, self.width, 3, device=self.scene.center.device))
        if group is None or dist.get_world_size(group) == 1:
            return mine
        n = dist.get_world_size(group)
        every = G.all_gather_rows(mine, group)
        at, parts = 0, {}
        for j in range(n):
            for b in range(j, n_bands, n):
                size = max(0, min(rows, self.height - b * rows))
                parts[b] = every[at:at + size]
                at += size
        return torch.cat([parts[b] for b in range(n_bands)])

    def _sharded_bands(self, eyes, mine, n_bands: int, rows: int, offset,
                       radius: float, grid, hits):
        """shard_photon_map=True: this rank's band images. Every band's
        walk records (point, normal, ok) reach every rank, each rank
        gathers every band's partial flux against its own sub-grid, and a
        band's owner adds the partials in rank order. hits gets the eye
        hits of this rank's bands."""
        group = self.group
        n = dist.get_world_size(group)
        walks = {b: eyes[b].walk(offset) for b in mine}
        hits.extend(w[3].sum() for w in walks.values())
        dev = self.scene.center.device
        lanes = -(-(self.width * rows) // 1024) * 1024
        rec = torch.zeros(0, 7, device=dev)
        if mine:
            rec = torch.cat([torch.cat([w[0], w[1], w[3][:, None].float()], 1)
                             for w in walks.values()])
        rec = G.all_gather_rows(rec, group).reshape(-1, lanes, 7)
        order = [b for j in range(n) for b in range(j, n_bands, n)]
        part = torch.cat([gather_hits(x[:, 0:3], x[:, 3:6], x[:, 6] > 0.5,
                                      radius, grid) for x in rec])
        part = G.all_gather_rows(part, group).reshape(n, n_bands, lanes, 3)
        out = []
        for b in mine:
            t = order.index(b)
            flux = part[0, t]
            for j in range(1, n):
                flux = flux + part[j, t]
            _, _, fd_beta, fd_ok = walks[b]
            out.append(eyes[b].finish(fd_beta, fd_ok, flux, radius))
        return out
