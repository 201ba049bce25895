"""PPM cone-filter photon gathers: over per-block lists of photon chunks
(the photon mapper's), and over raster-grid ranges (the older design).

Port of pathtracer_tpu/ops/pallas/gather_kernel.py: the adaptive chunk
gather (morton3, build_photon_chunks, block_chunk_lists, hit_morton_keys,
gather_flux_chunks_pallas) and the raster-grid gather (raster3,
build_photon_grid_morton, query_tables, gather_flux_pallas).
`gather_flux_chunks` and `gather_flux` launch the CUDA kernels
csrc/gather_chunks.cu and csrc/gather_flux.cu for CUDA tensors;
`gather_flux_chunks_plain` and `gather_flux_plain` are the same functions in
plain PyTorch, which the wrappers run for CPU tensors and which the tests
and chip_smoke.py hold the kernels against. The sorts, the grid and the
candidate filter around them are torch glue, as the JAX package runs them
in XLA. No caller renders through the raster gather: its dense grid needs a
cell of max(r, extent / 127), which a scene whose photons spread far (the
ganesha floor) makes hundreds of radii wide.

Photons are sorted by a 30-bit Morton code over their own bbox and cut into
128-photon chunks of four 32-photon sub-chunks, each with an exact f32 bbox.
Eye hits come sorted by their own Morton code, so each 1024-hit block is
spatially compact; per block, block_chunk_lists keeps the chunks with a
sub-chunk whose bbox meets the block's hit bbox grown by r, packed as
`chunk | sub_mask << 24`. The gather walks that list: for each listed chunk,
each sub-chunk whose mask bit is set, each photon in order, a lane adds
(1 - d/r) * flux where d^2 < r^2 and n . n_p > 1e-3. The per-photon test is
the exact one; the boxes only skip photons that add an exact zero.

A block's list is cut into segments of SEG positions: each segment is summed
from +0.0 into a partial, and a lane's partials are then added in segment
order from +0.0 (block_items numbers the segments). The kernel walks the
segments on different CTAs; the plain version sums in the same order, so
the two stay equal. A list of at most SEG chunks sums as one run.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _build
from ...utils import tracing
from .. import vec
from . import check_tensors

__all__ = ["morton3", "build_photon_chunks", "block_chunk_lists",
           "block_items", "hit_morton_keys", "gather_flux_chunks",
           "gather_flux_chunks_plain",
           "raster3", "build_photon_grid_morton", "query_tables",
           "warp_order", "gather_flux", "gather_flux_plain",
           "raster_pair_counts"]

BIG = float(np.float32(3.0e38))
BLOCK = 1024  # eye hits per block (one CTA of the kernel)
CHB = 128  # photons per chunk
SUB = 32  # photons per bbox sub-chunk
N_SUBS = CHB // SUB
MASK_SHIFT = 24  # list word = chunk | sub_mask << 24
N_PLANES = 16  # photons_t planes: pos3, nrm3, flux3, pad
_M32 = 0xFFFFFFFF
# list positions per segment: the unit of work of the kernel's CTAs and of
# the fixed summation order that the kernel and the plain version share
# (8: the fastest of 4-64 on cornell's lists, chip_smoke.py --sweep-seg)
SEG = 8
# blocks per step of the plain version: bounds its (blocks, 1024, 128)
# temporaries to 4 MB each
PLAIN_BLOCKS = 8
# the raster grid: SIDE cells per axis, a dense (start, count) table of
# SIDE^3 = 2,097,152 cells, and the 9 (dy, dz) rows of a hit's 3x3x3 cells
BITS = 7
SIDE = 1 << BITS
N_OFF = 9
_OFFSETS_YZ = [(y, z) for y in (-1, 0, 1) for z in (-1, 0, 1)]
# range positions per step of gather_flux_plain
RANGE_STEP = 64
# pairs of a warp's longest lane above which gather_flux's kernel walks the
# warp in batches (csrc/gather_flux.cu); chip_smoke.py phase 6 times the
# kernel with every warp batched and with none
HEAVY = 4096


def morton3(cx, cy, cz) -> torch.Tensor:
    """Interleave three 10-bit ints (x lowest) into an int32 key."""
    def expand(v):
        v = v.to(torch.int64) & _M32
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249
    key = expand(cx) | (expand(cy) << 1) | (expand(cz) << 2)
    return (key & _M32).to(torch.int32)


def _cells(p, valid):
    """10-bit Morton cells per axis of points p (N, 3) over the bbox of the
    `valid` ones. Rows that are not valid cast garbage (the float->int cast
    of an out-of-range value differs between XLA and torch); callers mask
    them after the cast, as the JAX code does."""
    vm = valid[:, None]
    lo = torch.amin(torch.where(vm, p, BIG), dim=0)
    hi = torch.amax(torch.where(vm, p, -BIG), dim=0)
    ext = torch.clamp(hi - lo, min=float(np.float32(1e-9)))
    c = ((p - lo[None, :]) / ext[None, :] * 1024.0).to(torch.int32)
    return torch.clamp(c, 0, 1023)


def hit_morton_keys(point, active) -> torch.Tensor:
    """30-bit Morton key of each hit over the active hits' bbox, the
    block-coherence sort key of the gather (inactive hits last)."""
    c = _cells(point, active)
    key = morton3(c[:, 0], c[:, 1], c[:, 2])
    return torch.where(active, key, 1 << 30)


def build_photon_chunks(pos, nrm, flux, valid):
    """Sort the deposits by Morton code (valid first, stable) and build the
    chunk tables. pos/nrm/flux (Np, 3) f32, valid (Np,) bool. Returns
      photons_t (16, Np_pad) f32 [pos3, nrm3, flux3, pad], Np_pad =
                ceil(Np / 128) * 128; deposits that are not valid carry BIG
                positions (their normals and fluxes go in unmasked), the
                padding columns BIG everywhere;
      sbox (6, Np_pad / 32) f32 [lo3, hi3] of each sub-chunk's valid
                photons; an empty sub-chunk's box is inverted (lo = BIG,
                hi = -BIG) and overlaps nothing."""
    npho = pos.shape[0]
    c = _cells(pos, valid)
    key = torch.where(valid, morton3(c[:, 0], c[:, 1], c[:, 2]), 1 << 30)
    order = torch.argsort(key, stable=True)
    posm = torch.where(valid[:, None], pos, BIG)
    planes = torch.cat([posm.T, nrm.T, flux.T,
                        valid.to(torch.float32)[None]])[:, order]
    np_pad = -(-npho // CHB) * CHB
    dev = pos.device
    tbl = torch.full((N_PLANES, np_pad), BIG, dtype=torch.float32, device=dev)
    tbl[0:9, :npho] = planes[0:9]
    vs = planes[9] > 0.5
    pad = np_pad - npho
    pv_lo = torch.cat([planes[0:3], torch.full((3, pad), BIG, device=dev)], 1)
    pv_hi = torch.cat([torch.where(vs, planes[0:3], -BIG),
                       torch.full((3, pad), -BIG, device=dev)], 1)
    n_sub = np_pad // SUB
    s_lo = torch.amin(pv_lo.reshape(3, n_sub, SUB), dim=2)
    s_hi = torch.amax(pv_hi.reshape(3, n_sub, SUB), dim=2)
    return tbl, torch.cat([s_lo, s_hi])


def _radius_f32(radius):
    """The gather's float32 radius terms (r, 1/r, r^2, r padded), rounded as
    the JAX code rounds them in float32."""
    r = np.float32(radius)
    return (r, np.float32(1.0) / r, r * r,
            r * np.float32(1.000002) + np.float32(1e-30))


def block_chunk_lists(point, active, sbox, radius):
    """Candidate filter: per 1024-hit block, the ascending list of the
    chunks with a sub-chunk whose box meets the block's active-hit bbox
    grown by the (padded) radius, each packed with its 4-bit sub mask.
    point (n, 3) Morton-sorted, n % 1024 == 0. Returns (lists (nblk, C)
    int32, counts (nblk,) int32), C = the number of chunks; entries past a
    block's count are the dead chunks, in chunk order."""
    n = point.shape[0]
    nblk = n // BLOCK
    n_sub = sbox.shape[1]
    n_chunks = n_sub // N_SUBS
    r_pad = float(_radius_f32(radius)[3])
    pr = point.reshape(nblk, BLOCK, 3)
    am = active.reshape(nblk, BLOCK, 1)
    blo = torch.amin(torch.where(am, pr, BIG), dim=1) - r_pad
    bhi = torch.amax(torch.where(am, pr, -BIG), dim=1) + r_pad
    ov = am[:, :, 0].any(dim=1)[:, None].expand(nblk, n_sub)
    for ax in range(3):
        ov = ov & (sbox[3 + ax][None, :] >= blo[:, ax:ax + 1]) \
            & (sbox[ax][None, :] <= bhi[:, ax:ax + 1])
    bits = 1 << torch.arange(N_SUBS, dtype=torch.int32, device=point.device)
    mask = torch.where(ov.reshape(nblk, n_chunks, N_SUBS), bits, 0).sum(
        dim=2, dtype=torch.int32)
    live = mask > 0
    ci = torch.arange(n_chunks, dtype=torch.int32, device=point.device)
    words = ci[None, :] | (mask << MASK_SHIFT)
    key = torch.where(live, ci[None, :], 1 << 30)
    order = torch.sort(key, dim=1, stable=True).indices
    return (torch.gather(words, 1, order),
            live.sum(dim=1, dtype=torch.int32))


def block_items(counts) -> torch.Tensor:
    """The gather's work items: item_start (nblk + 1,) int32, the exclusive
    cumsum of ceil(count / SEG) over the blocks, so that block b owns items
    item_start[b] .. item_start[b + 1] - 1 and its s-th item covers list
    positions [s * SEG, min((s + 1) * SEG, count)). Computed on the counts'
    device."""
    per = torch.div(counts + (SEG - 1), SEG, rounding_mode="floor")
    return torch.cat([per.new_zeros(1), torch.cumsum(per, 0)]).to(torch.int32)


def gather_flux_chunks_plain(point, normal, active, sbox, photons_t, radius):
    """Plain PyTorch version of gather_flux_chunks. Every lane sums each
    segment of SEG list positions from +0.0 in the kernel's order (list
    position, then sub-chunk, then photon), then adds the segments' sums in
    order from +0.0; vectorised over the lanes of PLAIN_BLOCKS blocks at a
    time. A block whose list has ended or whose sub bit is clear adds an
    exact +0.0. That takes (longest list x 128) sequential adds per step of
    blocks."""
    n = point.shape[0]
    nblk = n // BLOCK
    lists, counts = block_chunk_lists(point, active, sbox, radius)
    _, inv_r, r2, _ = _radius_f32(radius)
    inv_r, r2 = float(inv_r), float(r2)
    ndot_min = float(np.float32(1e-3))
    dev = point.device
    acc = torch.zeros(nblk, BLOCK, 3, dtype=torch.float32, device=dev)
    pts = point.reshape(nblk, BLOCK, 3)
    nrms = normal.reshape(nblk, BLOCK, 3)
    j128 = torch.arange(CHB, device=dev)
    sub_t = torch.arange(N_SUBS, device=dev)
    for b0 in range(0, nblk, PLAIN_BLOCKS):
        bs = slice(b0, min(nblk, b0 + PLAIN_BLOCKS))
        cnt = counts[bs].to(torch.int64)
        x, y, z = (pts[bs, :, c, None] for c in range(3))
        nx, ny, nz = (nrms[bs, :, c, None] for c in range(3))
        a = acc[bs]
        n_pos = int(cnt.max()) if cnt.numel() else 0
        for k in range(n_pos):
            if k % SEG == 0:
                part = torch.zeros_like(a)  # the segment's partial
            word = lists[bs, k].to(torch.int64) & _M32
            ci = word & ((1 << MASK_SHIFT) - 1)
            sub_on = (cnt > k)[:, None] & (((word >> MASK_SHIFT)[:, None]
                                            >> sub_t) & 1).bool()
            ph = photons_t[0:9][:, ci[:, None] * CHB + j128]  # (9, b, 128)
            p = [ph[c][:, None, :] for c in range(9)]
            dx, dy, dz = p[0] - x, p[1] - y, p[2] - z
            d2 = dx * dx + dy * dy + dz * dz
            ndot = p[3] * nx + p[4] * ny + p[5] * nz
            ok = (d2 < r2) & (ndot > ndot_min)
            wf = torch.where(ok, 1.0 - vec.sqrt(d2) * inv_r, 0.0)
            on = sub_on.repeat_interleave(SUB, dim=1)[:, None, :]
            contrib = torch.stack(
                [torch.where(on, wf * p[6 + c], 0.0) for c in range(3)], -1)
            for t in torch.nonzero(sub_on.any(dim=0)).flatten().tolist():
                for j in range(t * SUB, (t + 1) * SUB):
                    part = part + contrib[:, :, j]
            if k % SEG == SEG - 1 or k == n_pos - 1:
                a = a + part
        acc[bs] = a
    return torch.where(active[:, None], acc.reshape(n, 3), 0.0)


def gather_flux_chunks(point, normal, active, sbox, photons_t, radius):
    """Cone-filter gather for n eye hits (n % 1024 == 0, sorted by
    hit_morton_keys so blocks are compact). point/normal (n, 3) f32; active
    (n,) bool; sbox, photons_t from build_photon_chunks; radius a float.
    Returns flux (n, 3) f32; inactive lanes get zero.

    CPU tensors run gather_flux_chunks_plain; CUDA tensors build the chunk
    lists and their items in torch and launch csrc/gather_chunks.cu (its
    two passes counted as one launch in `gather_flux_chunks.launches`);
    anything else raises. The item count is read on the host (one
    synchronisation per call): it sizes the grid and the (items, 3, 1024)
    partial buffer, which no bound the host knows keeps small; it is a
    ppm.sync span of utils.tracing."""
    if point.device.type == "cpu":
        return gather_flux_chunks_plain(point, normal, active, sbox,
                                        photons_t, radius)
    if point.device.type != "cuda":
        raise ValueError(f"gather_flux_chunks: no kernel for {point.device}")
    n = point.shape[0]
    n_sub = sbox.shape[1] if sbox.dim() == 2 else 0
    check_tensors("gather_flux_chunks", point.device, [
        ("point", point, torch.float32, (n, 3)),
        ("normal", normal, torch.float32, (n, 3)),
        ("active", active, torch.bool, (n,)),
        ("sbox", sbox, torch.float32, (6, n_sub)),
        ("photons_t", photons_t, torch.float32, (N_PLANES, n_sub * SUB))])
    if not (n % BLOCK == 0 and n > 0 and n_sub % N_SUBS == 0 and n_sub > 0):
        raise ValueError(f"gather_flux_chunks: want n % {BLOCK} == 0 and "
                         f"whole chunks; got n = {n}, {n_sub} sub-chunks")
    if photons_t.data_ptr() % 16 or sbox.data_ptr() % 16:
        raise ValueError("gather_flux_chunks: photons_t and sbox must be "
                         "16-byte aligned (the kernel stages them with "
                         "16-byte copies)")
    lists, counts = block_chunk_lists(point, active, sbox, radius)
    item_start = block_items(counts)
    with tracing.span("ppm.sync"):
        n_items = int(item_start[-1])  # the host read
    hits = torch.cat([point.T, normal.T,
                      active.to(torch.float32)[None]]).contiguous()
    partial = torch.empty(max(n_items, 1), 3, BLOCK, dtype=torch.float32,
                          device=point.device)
    out = torch.empty(3, n, dtype=torch.float32, device=point.device)
    r, _, _, r_pad = _radius_f32(radius)
    lib = _build.load()
    err = lib.pt_gather_chunks(
        hits.data_ptr(), lists.data_ptr(), counts.data_ptr(),
        item_start.data_ptr(), lists.shape[1], photons_t.data_ptr(),
        photons_t.shape[1], sbox.data_ptr(), float(r), float(r_pad), SEG,
        n_items, partial.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(point.device).cuda_stream)
    _build.check(lib, err, "gather_flux_chunks")
    gather_flux_chunks.launches += 1
    return out.T


gather_flux_chunks.launches = 0


def raster3(cx, cy, cz):
    """Dense raster cell key, x fastest: (z * SIDE + y) * SIDE + x. A run
    [x0, x1] at fixed (y, z) is contiguous."""
    return (cz * SIDE + cy) * SIDE + cx


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _grid_cells(p, lo, cell_size) -> torch.Tensor:
    """floor((p - lo) / cell) per axis, int32, with the JAX code's float32
    reciprocal of the cell."""
    inv_c = 1.0 / _f32(cell_size, p.device)
    lo = _f32(lo, p.device)
    return torch.floor((p - lo[None, :]) * inv_c).to(torch.int32)


def build_photon_grid_morton(pos, nrm, flux, valid, lo, cell_size):
    """Sort the photons by raster cell key (stable, as lax.sort_key_val is)
    and build the dense per-cell ranges (the JAX name is kept; hits still
    sort by Morton key). pos/nrm/flux (Np, 3) f32; valid (Np,) bool; lo (3,)
    the grid origin, which must cover every valid deposit; cell_size >= the
    gather radius. Returns (photons_t (16, Np_pad) f32 [pos3, nrm3, flux3,
    pad], Np_pad = ceil(Np / 128) * 128, pad columns 3e38; start (SIDE^3,)
    int32; count (SIDE^3,) int32). Deposits that are not valid sort last
    and belong to no cell."""
    npho = pos.shape[0]
    c = torch.clamp(_grid_cells(pos, lo, cell_size), 0, SIDE - 1)
    m = SIDE ** 3
    key = torch.where(valid, raster3(c[:, 0], c[:, 1], c[:, 2]), m)
    order = torch.sort(key, stable=True).indices
    count = torch.bincount(key, minlength=m + 1)[:m]
    start = (torch.cumsum(count, 0) - count).to(torch.int32)
    np_pad = -(-npho // CHB) * CHB
    tbl = torch.full((N_PLANES, np_pad), BIG, dtype=torch.float32,
                     device=pos.device)
    tbl[0:9, :npho] = torch.cat([pos.T, nrm.T, flux.T])[:, order]
    return tbl, start, count.to(torch.int32)


def query_tables(point, active, lo, cell_size, start, count):
    """Per hit, its 9 raster ranges: s, e (9, n) int32, one [start, end)
    per (dy, dz) row of its 3x3x3 cells spanning x in [cx-1, cx+1] clamped
    to the grid; rows off the grid, and inactive hits, get empty ranges.
    Also own_key (n,) int32, the Morton key of the hit's own clamped cell,
    the hits' coherence sort key."""
    c = _grid_cells(point, lo, cell_size)  # (n, 3)
    offs = torch.tensor(_OFFSETS_YZ, dtype=torch.int32, device=point.device)
    yy = c[None, :, 1] + offs[:, 0:1]  # (9, n)
    zz = c[None, :, 2] + offs[:, 1:2]
    cx = c[None, :, 0]
    in_grid = ((yy >= 0) & (yy < SIDE) & (zz >= 0) & (zz < SIDE)
               & (cx >= -1) & (cx <= SIDE))
    yyl = torch.clamp(yy, 0, SIDE - 1)
    zzl = torch.clamp(zz, 0, SIDE - 1)
    key_lo = raster3(torch.clamp(cx - 1, 0, SIDE - 1), yyl, zzl).long()
    key_hi = raster3(torch.clamp(cx + 1, 0, SIDE - 1), yyl, zzl).long()
    ok = in_grid & active[None, :]
    s = torch.where(ok, start[key_lo], 0)
    e = torch.where(ok, start[key_hi] + count[key_hi], 0)
    cc = torch.clamp(c, 0, SIDE - 1)
    return s, e, morton3(cc[:, 0], cc[:, 1], cc[:, 2])


def gather_flux_plain(point, normal, s_tab, e_tab, photons_t, radius):
    """Plain PyTorch version of gather_flux: every lane sums its ranges in
    the kernel's order, offset 0..8 and then photon index ascending,
    vectorised over the lanes, RANGE_STEP positions at a time; a position
    past the lane's range, or a photon that fails the tests, adds nothing.
    That takes (sum over offsets of the longest range) sequential adds."""
    n = point.shape[0]
    _, inv_r, r2, _ = _radius_f32(radius)
    inv_r, r2 = float(inv_r), float(r2)
    ndot_min = float(np.float32(1e-3))
    x, y, z = (point[:, c, None] for c in range(3))
    nx, ny, nz = (normal[:, c, None] for c in range(3))
    acc = torch.zeros(3, n, dtype=torch.float32, device=point.device)
    steps = torch.arange(RANGE_STEP, device=point.device)
    for o in range(N_OFF):
        s, e = s_tab[o].long(), e_tab[o].long()
        longest = int((e - s).max()) if n else 0
        for k0 in range(0, longest, RANGE_STEP):
            j = s[:, None] + k0 + steps  # (n, RANGE_STEP)
            inr = j < e[:, None]
            p = photons_t[0:9][:, torch.where(inr, j, 0)]  # (9, n, STEP)
            dx, dy, dz = p[0] - x, p[1] - y, p[2] - z
            d2 = dx * dx + dy * dy + dz * dz
            ndot = p[3] * nx + p[4] * ny + p[5] * nz
            ok = inr & (d2 < r2) & (ndot > ndot_min)
            w = 1.0 - vec.sqrt(d2) * inv_r
            contrib = torch.where(ok, w * p[6:9], 0.0)  # (3, n, STEP)
            for t in range(min(RANGE_STEP, longest - k0)):
                acc = acc + contrib[:, :, t]
    return acc.T


def warp_order(s_tab, e_tab) -> torch.Tensor:
    """The 32-hit groups of gather_flux's kernel (one a warp), longest
    first: (n / 32,) int32, the groups sorted by the pairs of their longest
    lane (the sum of its 9 range lengths), descending, ties by index. The
    kernel runs its warps in this order, so that the longest start first;
    no hit's sum depends on it."""
    lane = (e_tab - s_tab).clamp(min=0).sum(dim=0)
    return torch.argsort(lane.view(-1, 32).amax(dim=1), descending=True,
                         stable=True).to(torch.int32)


def raster_pair_counts(point, normal, s_tab, e_tab, photons_t, radius,
                       step=1 << 24):
    """The hit-photon pairs of gather_flux, by how far a walk must take
    each: (pairs, near, accepted), Python ints. pairs: every pair of the
    hits' ranges; near: those with d^2 < r^2; accepted: those of them with
    n . n_p > 1e-3, the pairs that add to a sum. In the kernel's float32
    operations, `step` pairs at a time; for chip_smoke.py's bound."""
    _, _, r2, _ = _radius_f32(radius)
    ndot_min = float(np.float32(1e-3))
    pairs = near = accepted = 0
    for o in range(N_OFF):
        s = s_tab[o].long()
        length = (e_tab[o].long() - s).clamp(min=0)
        ends = torch.cumsum(length, 0)
        total = int(ends[-1]) if ends.numel() else 0
        pairs += total
        for p0 in range(0, total, step):
            k = torch.arange(p0, min(p0 + step, total), device=point.device)
            hit = torch.searchsorted(ends, k, right=True)
            p = photons_t[0:6][:, s[hit] + k - (ends[hit] - length[hit])]
            x, nrm = point[hit], normal[hit]
            dx, dy, dz = p[0] - x[:, 0], p[1] - x[:, 1], p[2] - x[:, 2]
            d2 = dx * dx + dy * dy + dz * dz
            ndot = p[3] * nrm[:, 0] + p[4] * nrm[:, 1] + p[5] * nrm[:, 2]
            close = d2 < float(r2)
            near += int(close.sum())
            accepted += int((close & (ndot > ndot_min)).sum())
    return pairs, near, accepted


def gather_flux(point, normal, s_tab, e_tab, photons_t, radius):
    """Cone-filter gather for n eye hits over their raster ranges (the JAX
    gather_flux_pallas; n % 1024 == 0, ideally sorted by the own_key of
    query_tables). point/normal (n, 3) f32; s_tab/e_tab (9, n) int32 from
    query_tables; photons_t (16, Np_pad) f32 from build_photon_grid_morton;
    radius a float. Returns flux (n, 3) f32: per lane, over the photons of
    its ranges with d^2 < r^2 and n . n_p > 1e-3, the sum of
    (1 - d / r) * flux.

    CPU tensors run gather_flux_plain; CUDA tensors launch
    csrc/gather_flux.cu (counted in `gather_flux.launches`); anything else
    raises."""
    if point.device.type == "cpu":
        return gather_flux_plain(point, normal, s_tab, e_tab, photons_t,
                                 radius)
    if point.device.type != "cuda":
        raise ValueError(f"gather_flux: no kernel for {point.device}")
    n = point.shape[0]
    np_pad = photons_t.shape[1] if photons_t.dim() == 2 else 0
    check_tensors("gather_flux", point.device, [
        ("point", point, torch.float32, (n, 3)),
        ("normal", normal, torch.float32, (n, 3)),
        ("s_tab", s_tab, torch.int32, (N_OFF, n)),
        ("e_tab", e_tab, torch.int32, (N_OFF, n)),
        ("photons_t", photons_t, torch.float32, (N_PLANES, np_pad))])
    if not (n > 0 and n % BLOCK == 0 and np_pad > 0):
        raise ValueError(f"gather_flux: want n % {BLOCK} == 0 and photons; "
                         f"got n = {n}, {np_pad} photon columns")
    hits = torch.cat([point.T, normal.T]).contiguous()
    order = warp_order(s_tab, e_tab)
    out = torch.empty(3, n, dtype=torch.float32, device=point.device)
    lib = _build.load()
    err = lib.pt_gather_flux(
        hits.data_ptr(), s_tab.data_ptr(), e_tab.data_ptr(),
        photons_t.data_ptr(), np_pad, float(_radius_f32(radius)[0]),
        order.data_ptr(), HEAVY, out.data_ptr(), n,
        torch.cuda.current_stream(point.device).cuda_stream)
    _build.check(lib, err, "gather_flux")
    gather_flux.launches += 1
    return out.T


gather_flux.launches = 0
