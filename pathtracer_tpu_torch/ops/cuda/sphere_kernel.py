"""Nearest-hit ray/sphere-set intersection: the sphere tables, the plain
PyTorch versions of the in-kernel intersection loops, the intersection half
of the two-kernel bounce, the nearest-sphere kernel of the photon mapper and
the clustered nearest-sphere kernel.

Port of pathtracer_tpu/ops/pallas/sphere_kernel.py (pack_spheres_pallas,
intersect_regs, intersect_regs_listed, intersect_state_pallas,
intersect_spheres_pallas, pack_spheres_clustered,
intersect_clustered_pallas). On the card the intersect_regs math runs inside
the fused bounce kernel (csrc/fused_bounce.cu) and the intersect_state
kernel (csrc/intersect_state.cu); intersect_spheres and intersect_clustered
launch csrc/intersect_spheres.cu and csrc/intersect_clustered.cu. Each
wrapper runs its plain version for CPU tensors.

Selection semantics of the path tracer's loops, kept exactly:
- the key is a*t with the /a dropped (directions are unit; the exact t is
  recomputed in shading);
- a negative discriminant makes sqrt NaN, and the update is the strict
  `(at < best) & (at >= 0)`, so NaN never wins;
- ties go to the lowest index (lists are ascending and padded with
  duplicates of their first entry);
- pad spheres carry A = -BIG and never hit.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _build, native
from .. import vec
from . import check_tensors

BIG = float(np.float32(3.0e38))
RAY_BLOCK = 1024  # rays per block: one 32x32 image tile at bounce 0
LANES = 128
LIST_UNROLL = 8  # per-block sphere lists are padded to a multiple of this
# rays per chunk of the plain version: bounds its (rays, spheres) temporaries
PLAIN_CHUNK = 8 * RAY_BLOCK
CLUSTER = 16  # spheres per cluster of the clustered tables
# blocks per step of intersect_clustered_plain: its (rays, spheres)
# temporaries hold 4096 x 16 K floats (47 MB each for K = 178)
CLUSTER_PLAIN_BLOCKS = 4


def pack_spheres(center: torch.Tensor, radius: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """(4, S) sphere table [cx, cy, cz, A = r^2 - |c|^2]; pads get A = -BIG."""
    c2 = center[:, 0] * center[:, 0] + center[:, 1] * center[:, 1] \
        + center[:, 2] * center[:, 2]
    a_s = torch.where(valid, radius * radius - c2,
                      torch.full_like(radius, -BIG))
    return torch.stack([center[:, 0], center[:, 1], center[:, 2], a_s])


def _select(cx, cy, cz, a_s, o, d, od, oq, origin_zero):
    """a*t keys of rays (R, 1) against spheres (R|1, K); NaN or negative
    keys become BIG, which never beats the BIG initial best."""
    d0, d1, d2 = d
    if origin_zero:
        bp = cx * d0 + cy * d1 + cz * d2
        g = a_s
    else:
        o0, o1, o2 = o
        bp = cx * d0 + cy * d1 + cz * d2 - od
        g = a_s + 2.0 * (cx * o0 + cy * o1 + cz * o2) - oq
    disc = g + bp * bp
    sq = vec.sqrt(disc)
    inside_pos = (g >= 0.0) & (bp >= 0.0)
    at = bp + torch.where(inside_pos, sq, -sq)
    return torch.where(at >= 0.0, at, torch.full_like(at, BIG))


def _ray_terms(o, d, origin_zero):
    if origin_zero:
        return None, None
    o0, o1, o2 = o
    d0, d1, d2 = d
    return o0 * d0 + o1 * d1 + o2 * d2, o0 * o0 + o1 * o1 + o2 * o2


def intersect_regs(sph_table, o0, o1, o2, d0, d1, d2, origin_zero):
    """Brute force over all S spheres. Rays are flat (N,) f32 components.
    Returns (best_at (N,) f32, best_idx (N,) int32); a miss is (BIG, 0)."""
    n = d0.shape[0]
    best_at = torch.empty_like(d0)
    best_idx = torch.empty(n, dtype=torch.int32, device=d0.device)
    sph = [sph_table[c][None, :] for c in range(4)]
    for lo in range(0, n, PLAIN_CHUNK):
        sl = slice(lo, min(n, lo + PLAIN_CHUNK))
        o = [x[sl, None] for x in (o0, o1, o2)]
        d = [x[sl, None] for x in (d0, d1, d2)]
        od, oq = _ray_terms(o, d, origin_zero)
        key = _select(*sph, o, d, od, oq, origin_zero)
        at, idx = torch.min(key, dim=1)  # first index among equal minima
        best_at[sl] = at
        best_idx[sl] = idx.to(torch.int32)
    return best_at, best_idx


def intersect_regs_listed(sph_table, lists, counts, o0, o1, o2, d0, d1, d2,
                          origin_zero):
    """Per-block list variant: ray i of the flat wavefront tests only the
    spheres lists[i // RAY_BLOCK, :counts[i // RAY_BLOCK]] (global indices,
    ascending). lists (n_blk, K) int32, counts (n_blk, 1) int32."""
    n = d0.shape[0]
    n_blk, k = lists.shape
    assert n == n_blk * RAY_BLOCK, (n, n_blk)
    best_at = torch.empty_like(d0)
    best_idx = torch.empty(n, dtype=torch.int32, device=d0.device)
    lists_l = lists.to(torch.int64)
    step = max(1, PLAIN_CHUNK // RAY_BLOCK)
    jj = torch.arange(k, device=d0.device)
    for b0 in range(0, n_blk, step):
        bs = slice(b0, min(n_blk, b0 + step))
        nb = bs.stop - bs.start
        sl = slice(bs.start * RAY_BLOCK, bs.stop * RAY_BLOCK)
        idx_b = lists_l[bs]  # (nb, K)
        # sphere params per block, broadcast over the block's rays
        sph = [sph_table[c][idx_b][:, None, :] for c in range(4)]
        o = [x[sl].reshape(nb, RAY_BLOCK, 1) for x in (o0, o1, o2)]
        d = [x[sl].reshape(nb, RAY_BLOCK, 1) for x in (d0, d1, d2)]
        od, oq = _ray_terms(o, d, origin_zero)
        key = _select(*sph, o, d, od, oq, origin_zero)
        in_list = (jj[None, :] < counts[bs, 0:1].to(torch.int64))[:, None, :]
        key = torch.where(in_list, key, torch.full_like(key, BIG))
        at, j = torch.min(key, dim=2)
        idx = torch.gather(idx_b, 1, j)  # (nb, RAY_BLOCK)
        # an empty list (count 0) keeps the initial (BIG, 0)
        idx = torch.where(at < BIG, idx, torch.zeros_like(idx))
        best_at[sl] = at.reshape(-1)
        best_idx[sl] = idx.reshape(-1).to(torch.int32)
    return best_at, best_idx


def check_state(what, state):
    """The wavefront contract of the path tracer's kernels: a (10, rows, 128)
    f32 state with rows a multiple of 8 (whole 1024-ray blocks), on the
    card. Returns rows."""
    if state.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {state.device}")
    if not (state.dim() == 3 and state.shape[0] == 10
            and state.shape[2] == LANES and state.shape[1] % 8 == 0):
        raise ValueError(f"{what}: state must be (10, 8k, {LANES}), got "
                         f"{tuple(state.shape)}")
    return state.shape[1]


def intersect_state_plain(sph_table, state, *, origin_zero: bool,
                          block_lists=None):
    """Plain PyTorch version of intersect_state: intersect_regs, or
    intersect_regs_listed with block_lists, over the state's rays, and
    (BIG, 0) on every dead lane."""
    comps = [state[c].reshape(-1) for c in range(6)]
    if block_lists is None:
        at, idx = intersect_regs(sph_table, *comps, origin_zero=origin_zero)
    else:
        lists, counts = block_lists
        at, idx = intersect_regs_listed(sph_table, lists, counts, *comps,
                                        origin_zero=origin_zero)
    alive = state[9].reshape(-1) > 0.0
    at = torch.where(alive, at, BIG)
    idx = torch.where(alive, idx, 0).to(torch.int32)
    return at.reshape(state.shape[1:]), idx.reshape(state.shape[1:])


def intersect_state(sph_table, state, *, origin_zero: bool, block_lists=None):
    """Nearest sphere of every ray of the (10, rows, 128) wavefront state
    (the JAX intersect_state_pallas): sph_table (4, S); block_lists =
    (lists (n_blk, K) int32, counts (n_blk, 1) int32) restricts each
    1024-ray block to its ascending list (bounce 0 in tile-major order);
    origin_zero: every ray starts at the origin. Returns (at (rows, 128) f32
    a*t key, idx (rows, 128) int32); a miss is (BIG, 0).

    Dead lanes: the JAX kernel fills a wholly dead 1024-ray block with
    (BIG, 0) but computes the dead lanes of a live block, which its shading
    never reads (shade_pallas takes `at` only where the lane is alive).
    Here every dead lane is (BIG, 0), in the kernel and its plain version.

    CPU tensors run intersect_state_plain; CUDA tensors launch
    csrc/intersect_state.cu (counted in `intersect_state.launches`);
    anything else raises."""
    if state.device.type == "cpu":
        return intersect_state_plain(sph_table, state, origin_zero=origin_zero,
                                     block_lists=block_lists)
    rows = check_state("intersect_state", state)
    n = rows * LANES
    n_s = sph_table.shape[1] if sph_table.dim() == 2 else 0
    checks = [("sph_table", sph_table, torch.float32, (4, n_s)),
              ("state", state, torch.float32, (10, rows, LANES))]
    lists = counts = None
    if block_lists is not None:
        lists, counts = block_lists
        n_blk = n // RAY_BLOCK
        checks += [("lists", lists, torch.int32, (n_blk, lists.shape[1])),
                   ("counts", counts, torch.int32, (n_blk, 1))]
    check_tensors("intersect_state", state.device, checks)
    if not 0 < n_s <= 8192:
        raise ValueError(f"intersect_state: want 0 < S <= 8192 spheres, got "
                         f"{n_s}")
    lib = _build.load()
    at = torch.empty(rows, LANES, dtype=torch.float32, device=state.device)
    idx = torch.empty(rows, LANES, dtype=torch.int32, device=state.device)
    err = lib.pt_intersect_state(
        sph_table.data_ptr(), n_s, state.data_ptr(),
        None if lists is None else lists.data_ptr(),
        None if counts is None else counts.data_ptr(),
        0 if lists is None else lists.shape[1], at.data_ptr(), idx.data_ptr(),
        n, int(bool(origin_zero)),
        torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(lib, err, "intersect_state")
    intersect_state.launches += 1
    return at, idx


intersect_state.launches = 0


def intersect_spheres_plain(table, org, d, alive):
    """Plain PyTorch version of intersect_spheres (the math of the JAX
    _kernel_body, operation for operation): the key is a*t for any |d|,
    disc = g + bp*bp/a, a NaN discriminant loses the strict
    `(at < best) & (at >= 0)` update, and a 1024-ray block with no live ray
    returns (BIG, 0) for all its rays while dead rays in a live block get
    computed values. Returns (at, idx int32, hit, inv_a), each (N,)."""
    n = org.shape[0]
    o0, o1, o2 = org[:, 0], org[:, 1], org[:, 2]
    d0, d1, d2 = d[:, 0], d[:, 1], d[:, 2]
    od = o0 * d0 + o1 * d1 + o2 * d2
    oq = o0 * o0 + o1 * o1 + o2 * o2
    a = d0 * d0 + d1 * d1 + d2 * d2
    inv_a = 1.0 / a
    best_at = torch.full_like(a, BIG)
    best_idx = torch.zeros(n, dtype=torch.int32, device=org.device)
    for s in range(table.shape[1]):
        cx, cy, cz, a_s = table[0, s], table[1, s], table[2, s], table[3, s]
        bp = cx * d0 + cy * d1 + cz * d2 - od
        g = a_s + 2.0 * (cx * o0 + cy * o1 + cz * o2) - oq
        disc = g + bp * bp * inv_a
        sq = vec.sqrt(a * disc)
        inside_pos = (g >= 0.0) & (bp >= 0.0)
        at = bp + torch.where(inside_pos, sq, -sq)
        upd = (at < best_at) & (at >= 0.0)
        best_at = torch.where(upd, at, best_at)
        best_idx = torch.where(upd, s, best_idx).to(torch.int32)
    live = alive.reshape(-1, RAY_BLOCK).any(dim=1)
    live = live.repeat_interleave(RAY_BLOCK)
    best_at = torch.where(live, best_at, BIG)
    best_idx = torch.where(live, best_idx, 0).to(torch.int32)
    return best_at, best_idx, best_at < BIG, inv_a


def check_rays(name, org, d, alive):
    """The ray contract of the nearest-hit kernels: org, d contiguous
    (N, 3) f32 with N a multiple of 1024 and alive (N,) bool, all on one
    device."""
    n = org.shape[0]
    ok = (org.dim() == 2 and org.shape[1] == 3 and n % RAY_BLOCK == 0
          and org.dtype == d.dtype == torch.float32
          and tuple(d.shape) == tuple(org.shape) and d.device == org.device
          and org.is_contiguous() and d.is_contiguous()
          and alive.dtype == torch.bool and tuple(alive.shape) == (n,)
          and alive.device == org.device and alive.is_contiguous())
    if not ok:
        raise ValueError(f"{name}: want contiguous f32 org, d (N, 3) with N "
                         f"% {RAY_BLOCK} == 0 and alive (N,) bool on one "
                         f"device; got org {tuple(org.shape)} {org.dtype} "
                         f"{org.device}, d {tuple(d.shape)} {d.dtype}")


def intersect_spheres(table, org, d, alive):
    """Nearest hit of N rays against the (4, S) sphere table (the JAX
    intersect_spheres_pallas). org, d: (N, 3) f32, N a multiple of 1024;
    alive: (N,) bool, for the per-block early exit. Returns
    (at (N,) = a*t key, idx (N,) int32, hit (N,) bool, inv_a (N,)).

    CPU tensors run intersect_spheres_plain; CUDA tensors launch
    csrc/intersect_spheres.cu (counted in `intersect_spheres.launches`);
    anything else raises."""
    if org.device.type == "cpu":
        return intersect_spheres_plain(table, org, d, alive)
    if org.device.type != "cuda":
        raise ValueError(f"intersect_spheres: no kernel for {org.device}")
    check_rays("intersect_spheres", org, d, alive)
    n_s = table.shape[1] if table.dim() == 2 else 0
    if not (table.dim() == 2 and table.shape[0] == 4 and 0 < n_s <= 2048
            and table.dtype == torch.float32 and table.is_contiguous()
            and table.device == org.device):
        raise ValueError("intersect_spheres: want a contiguous f32 (4, S) "
                         f"table, 0 < S <= 2048, on {org.device}; got "
                         f"{tuple(table.shape)} {table.dtype} {table.device}")
    n = org.shape[0]
    lib = _build.load()
    at = torch.empty(n, dtype=torch.float32, device=org.device)
    idx = torch.empty(n, dtype=torch.int32, device=org.device)
    inv_a = torch.empty(n, dtype=torch.float32, device=org.device)
    err = lib.pt_intersect_spheres(
        table.data_ptr(), n_s, org.data_ptr(), d.data_ptr(), alive.data_ptr(),
        at.data_ptr(), idx.data_ptr(), inv_a.data_ptr(), n,
        torch.cuda.current_stream(org.device).cuda_stream)
    _build.check(lib, err, "intersect_spheres")
    intersect_spheres.launches += 1
    return at, idx, at < BIG, inv_a


intersect_spheres.launches = 0


def pack_spheres_clustered(center, radius, valid):
    """Cluster the valid spheres into the leaves of a binned-SAH BVH of at
    most CLUSTER spheres (native.bvh_build with length_cutoff 16 and 16
    bins, the tree of the JAX packer), pad each cluster to CLUSTER with
    never-hit spheres (A = -BIG), and bound each cluster by the
    circumsphere of its box. Host numpy, the JAX packer's arithmetic.
    Returns (sph_table (4, 16 K) f32, cluster_table (4, K) f32 [centre,
    r^2], perm (16 K,) int32 original sphere index of each slot), on the
    device of `center`."""
    center_np = center.cpu().numpy().astype(np.float32)
    radius_np = radius.cpu().numpy().astype(np.float32)
    idx = np.nonzero(valid.cpu().numpy())[0]
    lo = center_np[idx] - radius_np[idx][:, None]
    hi = center_np[idx] + radius_np[idx][:, None]
    _, _, meta, order, _, _ = native.bvh_build(lo, hi, length_cutoff=CLUSTER,
                                               num_bins=16)
    leaves = meta[meta[:, 1] > 0]
    k = len(leaves)
    sph = np.zeros((4, k * CLUSTER), np.float32)
    sph[3, :] = -BIG  # pad: never hits
    perm = np.zeros(k * CLUSTER, np.int32)
    clus = np.zeros((4, k), np.float32)
    for ci, (first, count, _skip) in enumerate(leaves):
        prims = idx[order[first:first + count]]
        base = ci * CLUSTER
        c = center_np[prims]
        r = radius_np[prims]
        sph[0:3, base:base + count] = c.T
        sph[3, base:base + count] = r * r - (c * c).sum(1)
        perm[base:base + count] = prims
        blo = (c - r[:, None]).min(0)
        bhi = (c + r[:, None]).max(0)
        cc = 0.5 * (blo + bhi)
        cr = float(np.linalg.norm(bhi - cc))
        clus[0:3, ci] = cc
        clus[3, ci] = cr * cr
    dev = center.device
    return (torch.from_numpy(sph).to(dev), torch.from_numpy(clus).to(dev),
            torch.from_numpy(perm).to(dev))


def intersect_clustered_plain(tables, org, d, alive):
    """Plain PyTorch version of intersect_clustered, CLUSTER_PLAIN_BLOCKS
    blocks at a time. Per block and cluster, the cull test of every live
    lane, any-reduced over the block; every lane of the block tests the
    spheres of the clusters that survive, in the intersect_spheres form
    (an explicit disc >= 0 and at >= 0 test, BIG otherwise). The first index
    of the least candidate wins, as the kernel's strict `<` in ascending
    order does; idx goes out through perm."""
    sph, clus, perm = tables
    n = org.shape[0]
    o0, o1, o2 = org[:, 0], org[:, 1], org[:, 2]
    d0, d1, d2 = d[:, 0], d[:, 1], d[:, 2]
    od = o0 * d0 + o1 * d1 + o2 * d2
    oq = o0 * o0 + o1 * o1 + o2 * o2
    a = d0 * d0 + d1 * d1 + d2 * d2
    inv_a = 1.0 / a
    best_at = torch.empty_like(a)
    best_idx = torch.empty(n, dtype=torch.int64, device=org.device)
    ccx, ccy, ccz, cr2 = (clus[c][None, :] for c in range(4))
    cx, cy, cz, a_s = (sph[c][None, :] for c in range(4))
    step = CLUSTER_PLAIN_BLOCKS * RAY_BLOCK
    for lo in range(0, n, step):
        sl = slice(lo, min(n, lo + step))
        nb = (sl.stop - sl.start) // RAY_BLOCK
        r0, r1, r2 = (x[sl, None] for x in (o0, o1, o2))
        e0, e1, e2 = (x[sl, None] for x in (d0, d1, d2))
        ra, rinv, rod, roq = (x[sl, None] for x in (a, inv_a, od, oq))
        # the block cull, per cluster
        fx, fy, fz = ccx - r0, ccy - r1, ccz - r2
        fb = fx * e0 + fy * e1 + fz * e2
        fq = fx * fx + fy * fy + fz * fz
        perp2 = fq - fb * fb * rinv
        may_hit = (((perp2 <= cr2) | (fq <= cr2))
                   & (fb >= -vec.sqrt(cr2 * ra)) & alive[sl, None])
        run = may_hit.reshape(nb, RAY_BLOCK, -1).any(dim=1)  # (nb, K)
        run = run.repeat_interleave(CLUSTER, dim=1)[:, None, :]
        # every lane against every sphere; culled clusters give BIG
        bp = cx * e0 + cy * e1 + cz * e2 - rod
        g = a_s + 2.0 * (cx * r0 + cy * r1 + cz * r2) - roq
        disc = g + bp * bp * rinv
        sq = vec.sqrt(ra * disc)
        inside_pos = (g >= 0.0) & (bp >= 0.0)
        at = bp + torch.where(inside_pos, sq, -sq)
        cand = torch.where((disc >= 0.0) & (at >= 0.0), at, BIG)
        cand = torch.where(run, cand.reshape(nb, RAY_BLOCK, -1), BIG)
        at_min, j = torch.min(cand.reshape(nb * RAY_BLOCK, -1), dim=1)
        best_at[sl] = at_min
        best_idx[sl] = torch.where(at_min < BIG, j, 0)
    return best_at, perm[best_idx], best_at < BIG, inv_a


def intersect_clustered(tables, org, d, alive):
    """Nearest hit of N rays against the clustered tables of
    pack_spheres_clustered (the JAX intersect_clustered_pallas): the
    contract of intersect_spheres, with a per-1024-ray-block cull of each
    cluster by its bounding sphere. idx is an original sphere index (mapped
    through perm); a miss is (BIG, perm[0]).

    CPU tensors run intersect_clustered_plain; CUDA tensors launch
    csrc/intersect_clustered.cu (counted in `intersect_clustered.launches`);
    anything else raises."""
    if org.device.type == "cpu":
        return intersect_clustered_plain(tables, org, d, alive)
    if org.device.type != "cuda":
        raise ValueError(f"intersect_clustered: no kernel for {org.device}")
    check_rays("intersect_clustered", org, d, alive)
    sph, clus, perm = tables
    k = clus.shape[1] if clus.dim() == 2 else 0
    check_tensors("intersect_clustered", org.device, [
        ("sph_table", sph, torch.float32, (4, k * CLUSTER)),
        ("cluster_table", clus, torch.float32, (4, k)),
        ("perm", perm, torch.int32, (k * CLUSTER,))])
    if not 0 < k <= 800:  # 17 float4 a cluster in 227 KB of shared memory
        raise ValueError(f"intersect_clustered: want 0 < K <= 800 clusters, "
                         f"got {k}")
    n = org.shape[0]
    lib = _build.load()
    at = torch.empty(n, dtype=torch.float32, device=org.device)
    idx = torch.empty(n, dtype=torch.int32, device=org.device)
    inv_a = torch.empty(n, dtype=torch.float32, device=org.device)
    err = lib.pt_intersect_clustered(
        sph.data_ptr(), clus.data_ptr(), k, perm.data_ptr(), org.data_ptr(),
        d.data_ptr(), alive.data_ptr(), at.data_ptr(), idx.data_ptr(),
        inv_a.data_ptr(), n, torch.cuda.current_stream(org.device).cuda_stream)
    _build.check(lib, err, "intersect_clustered")
    intersect_clustered.launches += 1
    return at, idx, at < BIG, inv_a


intersect_clustered.launches = 0
