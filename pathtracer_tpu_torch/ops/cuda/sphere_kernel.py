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

from typing import NamedTuple

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


# The sphere hierarchy of the full-variant bounce (csrc/pt_bounce.cuh).
SPHERE_LEAF = 8  # most spheres a leaf holds
GROUP_LEAVES = 4  # most leaves a group holds
WARP = 32  # lanes whose cull tests one any-lane vote decides
# a node's bound grows by CULL_SLOPE * (|C| + R + |o|), |o| the ray origin's
# length (the proof is in csrc/pt_bounce.cuh); a lane whose |d|^2 lies
# outside 1 +- DIR_TOL, or whose |o|^2 is not under ORG_Q_MAX (NaN
# included), enters every node; a sphere with |c| + r not under FAR is
# unconditional
CULL_SLOPE = 2.0 ** -7
DIR_TOL = 2.0 ** -17
ORG_Q_MAX = 2.0 ** 100
FAR = 2.0 ** 50


class SphereBVH(NamedTuple):
    """A per-scene two-level hierarchy over the (4, S) sphere table, for
    the cull of the full-variant bounce: groups of at most GROUP_LEAVES
    leaves, leaves of at most SPHERE_LEAF spheres, both in the depth-first
    order of a binned-SAH tree. order (U + P,) int32: sphere indices, the U
    unconditional spheres first, then each leaf's run; nodes (G + L, 4) f32
    [Cx, Cy, Cz, RL], the G groups then the L leaves: the bound's centre
    and its grown radius R + CULL_SLOPE * (|C| + R), rounded up; links
    (G + L, 4) int32 [first, count, 0, 0]: a group's leaves are nodes
    [first, first + count), a leaf's run is order[first:first + count]."""
    order: torch.Tensor
    nodes: torch.Tensor
    links: torch.Tensor
    n_uncond: int
    n_groups: int


def _sphere_radii(sph_table):
    """Centres (S, 3) f64, the radius sqrt(A + |c|^2) that the pair test's
    A implies, in f64, and the pads: A = -BIG and |c| under FAR, which no
    lane that the cull serves can hit (disc = A + ... stays negative)."""
    t = sph_table.detach().cpu().numpy().astype(np.float64)
    c = np.ascontiguousarray(t[:3].T)
    with np.errstate(invalid="ignore"):
        pad = (t[3] <= -0.5 * BIG) & (np.linalg.norm(c, axis=1) < FAR)
        r = np.sqrt(np.maximum(t[3] + (c * c).sum(1), 0.0))
    return c, r, pad


def _bound(c, r):
    """The bound of spheres (c, r): centre C (f32 values) and radius R =
    max |c - C| + r in f64."""
    cen = (0.5 * ((c - r[:, None]).min(0) + (c + r[:, None]).max(0)))
    cen = cen.astype(np.float32).astype(np.float64)
    return cen, float((np.linalg.norm(c - cen, axis=1) + r).max())


def _round_up_f32(x: float) -> np.float32:
    y = np.float32(x)
    return np.nextafter(y, np.float32(np.inf)) if float(y) < x else y


def _grown(c, r, spheres):
    """[Cx, Cy, Cz, RL] of the bound of `spheres`: R grown by CULL_SLOPE *
    (|C| + R) and rounded up to float32."""
    cen, rad = _bound(c[spheres], r[spheres])
    return list(cen) + [_round_up_f32(
        rad + CULL_SLOPE * (float(np.linalg.norm(cen)) + rad))]


def build_sphere_bvh(sph_table) -> SphereBVH:
    """The hierarchy of the full-variant cull, on the host, on the device
    of sph_table. Valid spheres larger than half the diagonal of the box of
    all the others (shirley's ground) are unconditional: the cull cannot
    bound them, since their pair test cancels ~r^2 against ~r^2; so are
    entries that are not finite or lie past FAR. The rest go into
    native.bvh_build's binned-SAH tree (as pack_spheres_clustered
    builds it), whose subtrees of at most SPHERE_LEAF spheres become
    leaves, and whose subtrees of at most GROUP_LEAVES of those leaves
    become groups: every sphere but the pads is in exactly one leaf or
    unconditional."""
    c, r, pad = _sphere_radii(sph_table)
    with np.errstate(invalid="ignore"):
        near = np.linalg.norm(c, axis=1) + r < FAR  # False for NaN
    uncond = [int(s) for s in np.nonzero(~pad & ~near)[0]]
    idx = np.nonzero(~pad & near)[0]
    for s in idx[np.argsort(-r[idx], kind="stable")]:
        rest = np.setdiff1d(idx, uncond + [s])
        if len(rest) == 0:
            break
        lo = (c[rest] - r[rest, None]).min(0)
        hi = (c[rest] + r[rest, None]).max(0)
        if not r[s] > 0.5 * np.linalg.norm(hi - lo):
            break
        uncond.append(int(s))
    prims = np.setdiff1d(idx, uncond)
    groups = []  # per group, its leaves' sphere indices
    if len(prims):
        lo = (c[prims] - r[prims, None]).astype(np.float32)
        hi = (c[prims] + r[prims, None]).astype(np.float32)
        _, _, meta, perm, _, _ = native.bvh_build(
            lo, hi, length_cutoff=SPHERE_LEAF, num_bins=16)

        def children(k):
            ch = k + 1
            while ch < meta[k, 2]:
                yield ch
                ch = meta[ch, 2]

        def leaves(k):  # subtrees of at most SPHERE_LEAF spheres
            _, count, skip = meta[k]
            sub = meta[k:skip]
            sub = sub[sub[:, 1] > 0]  # their runs are contiguous
            if count or sub[:, 1].sum() <= SPHERE_LEAF:
                run = perm[sub[0, 0]:sub[-1, 0] + sub[-1, 1]]
                return [np.sort(prims[run])]
            return [lf for ch in children(k) for lf in leaves(ch)]

        def grouped(k):  # subtrees of at most GROUP_LEAVES leaves
            lv = leaves(k)
            if len(lv) <= GROUP_LEAVES:
                return [lv]
            return [g for ch in children(k) for g in grouped(ch)]

        groups = grouped(0)
    order = [np.array(sorted(uncond), np.int64)]
    g_nodes, l_nodes, g_links, l_links = [], [], [], []
    pos = len(order[0])
    for lv in groups:
        g_links.append([len(groups) + len(l_nodes), len(lv), 0, 0])
        g_nodes.append(_grown(c, r, np.concatenate(lv)))
        for spheres in lv:
            l_links.append([pos, len(spheres), 0, 0])
            l_nodes.append(_grown(c, r, spheres))
            order.append(spheres)
            pos += len(spheres)
    dev = sph_table.device
    return SphereBVH(
        torch.from_numpy(np.concatenate(order).astype(np.int32)).to(dev),
        torch.tensor(np.array(g_nodes + l_nodes, np.float32)
                     .reshape(-1, 4)).to(dev),
        torch.tensor(np.array(g_links + l_links, np.int32)
                     .reshape(-1, 4)).to(dev),
        len(uncond), len(groups))


def cull_lanes(hier: SphereBVH, o, d, origin_zero: bool):
    """Each lane's conservative node test, in the kernel's arithmetic:
    (N, M) bool, True where the lane may hit a sphere under the node."""
    return bound_votes(hier.nodes, o, d, origin_zero)


def bound_votes(nodes, o, d, origin_zero: bool):
    """The conservative test of rays (N,) against grown bounds nodes (M, 4)
    [Cx, Cy, Cz, RL], in the arithmetic of csrc/pt_bounce.cuh and
    csrc/intersect_clustered.cu: (N, M) bool, True where the lane may hit
    a sphere under the bound, and everywhere for a lane outside the proof
    (|d|^2 off 1 by more than DIR_TOL, |o|^2 not under ORG_Q_MAX, NaN)."""
    d0, d1, d2 = d
    cx, cy, cz, rl = (nodes[:, c][None, :] for c in range(4))
    if origin_zero:
        w0, w1, w2 = cx, cy, cz
        oq = torch.zeros_like(d0)
        mon = torch.zeros_like(d0)
    else:
        o0, o1, o2 = o
        oq = o0 * o0 + o1 * o1 + o2 * o2
        mon = CULL_SLOPE * vec.sqrt(oq)
        w0, w1, w2 = cx - o0[:, None], cy - o1[:, None], cz - o2[:, None]
    a2 = d0 * d0 + d1 * d1 + d2 * d2
    brute = ~(torch.abs(a2 - 1.0) <= DIR_TOL) | ~(oq <= ORG_Q_MAX)
    d0, d1, d2 = d0[:, None], d1[:, None], d2[:, None]
    b = w0 * d0 + w1 * d1 + w2 * d2
    q = w0 * w0 + w1 * w1 + w2 * w2
    lim = rl + mon[:, None]
    may = ~(q - b * b > lim * lim) & ~(b < -lim)
    return may | brute[:, None]


def cull_walk(hier: SphereBVH, may, alive):
    """The warps' walk over the hierarchy: a warp (WARP consecutive lanes)
    tests every group, and the leaves of each group it enters; it enters a
    node when any of its live lanes may hit under it. may (N, M) bool from
    cull_lanes, alive (N,) bool. Returns (visited, entered), each
    (N / WARP, M) bool."""
    m, n_groups = hier.nodes.shape[0], hier.n_groups
    links = hier.links.tolist()
    vote = (may & alive[:, None]).reshape(-1, WARP, m).any(dim=1)
    visited = torch.zeros_like(vote)
    visited[:, :n_groups] = True
    for g in range(n_groups):
        first, count = links[g][:2]
        visited[:, first:first + count] = vote[:, g:g + 1]
    return visited, visited & vote


def intersect_culled_plain(sph_table, hier: SphereBVH, o0, o1, o2, d0, d1,
                           d2, alive, origin_zero: bool):
    """The full-variant kernel's visit order in plain PyTorch: per lane the
    unconditional spheres, then the spheres of each leaf that the lane's
    warp enters (in an entered group), leaves in depth-first order, each
    pair taken by the (key,
    index) rule `at >= 0 && (at < best || (at == best && s < best_idx))`
    from (BIG, 0). Equals intersect_regs on the live lanes. Returns
    (best_at, best_idx, stats): stats counts per warp its live lanes, the
    nodes visited, the leaves entered and the spheres tested."""
    n = d0.shape[0]
    o, d = (o0, o1, o2), (d0, d1, d2)
    may = cull_lanes(hier, o, d, origin_zero)
    visited, entered = cull_walk(hier, may, alive)
    lane_warp = torch.arange(n, device=d0.device) // WARP
    order = hier.order.tolist()
    links = hier.links.tolist()
    best_at = torch.full_like(d0, BIG)
    best_idx = torch.zeros(n, dtype=torch.int64, device=d0.device)
    oc = [x[:, None] for x in o]
    dc = [x[:, None] for x in d]
    od, oq = _ray_terms(oc, dc, origin_zero)

    def take(j, lanes):
        s = order[j]
        at = _select(*(sph_table[c, s:s + 1][None, :] for c in range(4)),
                     oc, dc, od, oq, origin_zero)[:, 0]
        upd = lanes & (at >= 0.0) & ((at < best_at) | ((at == best_at)
                                                      & (s < best_idx)))
        best_at.copy_(torch.where(upd, at, best_at))
        best_idx.copy_(torch.where(upd, s, best_idx))

    everyone = torch.ones(n, dtype=torch.bool, device=d0.device)
    for j in range(hier.n_uncond):
        take(j, everyone)
    leaf_size = hier.links[:, 1].to(torch.int64).to(d0.device)
    leaf_size[:hier.n_groups] = 0
    for k in range(hier.n_groups, len(links)):
        lanes = entered[lane_warp, k]
        first, count = links[k][:2]
        for j in range(first, first + count):
            take(j, lanes)
    stats = {"live_lanes": alive.reshape(-1, WARP).sum(1),
             "nodes_visited": visited.sum(1),
             "leaves_entered": (entered & (leaf_size > 0)).sum(1),
             "spheres_tested": hier.n_uncond + (entered.long()
                                                * leaf_size).sum(1)}
    return best_at, best_idx.to(torch.int32), stats


SMEM_MAX = 232_448  # shared memory a CTA may take on the card


def tree_args(what: str, sphere_bvh, device, n_s: int, listed: bool):
    """The hierarchy's part of a bounce kernel's C arguments: (order,
    n_order, n_uncond, nodes, links, n_nodes, n_groups), all None / 0 for
    the listed variant. The full variant on the card needs the hierarchy;
    raises without it, when nodes or links are not 16-byte aligned (the
    kernel reads their rows as float4 / int4) or when it does not fit the
    CTA's shared memory."""
    if listed:
        return None, 0, 0, None, None, 0, 0
    if sphere_bvh is None:
        raise ValueError(f"{what}: the full variant needs sphere_bvh "
                         "(build_sphere_bvh of the sphere table)")
    order, nodes, links, n_uncond, n_groups = sphere_bvh
    n_order, m = order.shape[0], nodes.shape[0]
    check_tensors(what, device, [
        ("sphere_bvh.order", order, torch.int32, (n_order,)),
        ("sphere_bvh.nodes", nodes, torch.float32, (m, 4)),
        ("sphere_bvh.links", links, torch.int32, (m, 4))])
    if nodes.data_ptr() % 16 or links.data_ptr() % 16:
        raise ValueError(f"{what}: sphere_bvh.nodes and links must be "
                         "16-byte aligned (the kernel reads them as float4 "
                         "/ int4 rows)")
    if not (0 <= n_uncond <= n_order <= n_s and 0 <= n_groups <= m
            and n_order + m > 0):
        raise ValueError(f"{what}: sphere_bvh of {n_order} entries ({n_uncond}"
                         f" unconditional) for {n_s} spheres")
    if 20 * n_order + 32 * m > SMEM_MAX:
        raise ValueError(f"{what}: sphere_bvh takes more than {SMEM_MAX} B "
                         "of shared memory")
    return (order.data_ptr(), n_order, n_uncond, nodes.data_ptr(),
            links.data_ptr(), m, n_groups)


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
                          block_lists=None, sphere_bvh=None):
    """Plain PyTorch version of intersect_state: intersect_regs, or
    intersect_regs_listed with block_lists, over the state's rays, and
    (BIG, 0) on every dead lane. sphere_bvh is not read: the kernel's walk
    gives intersect_regs' result."""
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


def intersect_state(sph_table, state, *, origin_zero: bool, block_lists=None,
                    sphere_bvh=None):
    """Nearest sphere of every ray of the (10, rows, 128) wavefront state
    (the JAX intersect_state_pallas): sph_table (4, S); block_lists =
    (lists (n_blk, K) int32, counts (n_blk, 1) int32) restricts each
    1024-ray block to its ascending list (bounce 0 in tile-major order);
    without them the kernel walks sphere_bvh (build_sphere_bvh of the same
    table), which it then needs; origin_zero: every ray starts at the
    origin. Returns (at (rows, 128) f32 a*t key, idx (rows, 128) int32); a
    miss is (BIG, 0).

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
    tree = tree_args("intersect_state", sphere_bvh, state.device, n_s,
                     lists is not None)
    lib = _build.load()
    at = torch.empty(rows, LANES, dtype=torch.float32, device=state.device)
    idx = torch.empty(rows, LANES, dtype=torch.int32, device=state.device)
    err = lib.pt_intersect_state(
        sph_table.data_ptr(), n_s, state.data_ptr(),
        None if lists is None else lists.data_ptr(),
        None if counts is None else counts.data_ptr(),
        0 if lists is None else lists.shape[1], *tree, at.data_ptr(),
        idx.data_ptr(), n, int(bool(origin_zero)),
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


class ClusterWalk(NamedTuple):
    """The walk tables of csrc/intersect_clustered.cu, built on the host
    once per table set (cluster_walk, kept by cached_cluster_walk). runs (K, 2) int32 [first, count]:
    cluster c's real slots are c * CLUSTER + [0, count), every later slot of
    it a pad word (0, 0, 0, -BIG), and the kernel stages them at positions
    first + [0, count) (first: the counts' exclusive prefix sum). bounds
    (K, 4) f32 [Cx, Cy, Cz, RL]: the bound of those slots' spheres, grown as
    the sphere hierarchy's nodes are (_grown) and at least BOUND_FLOOR; RL
    is inf where a slot is not finite or reaches past FAR, and the bound of
    a cluster with no real slot is 0. n_real: the counts' sum."""
    runs: torch.Tensor
    bounds: torch.Tensor
    n_real: int


# least RL of a cluster's grown bound: lifts the warp skip's margins over
# every subnormal rounding (the proof is in csrc/intersect_clustered.cu)
BOUND_FLOOR = 2.0 ** -60


def cluster_walk(tables) -> ClusterWalk:
    """The ClusterWalk of pack_spheres_clustered's tables, on their device:
    each cluster's real slots (up to its last word that is not a pad) and
    the grown bound of their spheres, with the radius sqrt(A + |c|^2) that
    the pair test's A implies (_sphere_radii)."""
    sph, clus, _ = tables
    k = clus.shape[1]
    t = sph.detach().cpu().numpy()
    c, r, _ = _sphere_radii(sph)
    real = ~((t[0] == 0) & (t[1] == 0) & (t[2] == 0) & (t[3] == -BIG))
    real = real.reshape(k, CLUSTER)
    count = np.where(real.any(axis=1),
                     CLUSTER - np.argmax(real[:, ::-1], axis=1), 0)
    bounds = np.zeros((k, 4), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for ci in range(k):
            s = ci * CLUSTER + np.arange(count[ci])
            if not len(s):
                continue
            if not (np.linalg.norm(c[s], axis=1) + r[s] < FAR).all():
                bounds[ci, 3] = np.inf  # every lane enters
                continue
            grown = _grown(c, r, s)
            bounds[ci] = grown[:3] + [max(grown[3], np.float32(BOUND_FLOOR))]
    runs = np.stack([np.cumsum(count) - count, count], axis=1)
    dev = sph.device
    return ClusterWalk(torch.from_numpy(runs.astype(np.int32)).to(dev),
                       torch.from_numpy(bounds).to(dev), int(count.sum()))


def cached_cluster_walk(tables) -> ClusterWalk:
    """cluster_walk(tables), built once per sphere table: kept on the
    table tensor itself beside the tensor's version counter, so that an
    in-place change of the table builds it anew and no other table reads
    it. (The walk depends on the sphere table alone.) An inference
    tensor has no version counter: its walk is built at every call."""
    sph = tables[0]
    if sph.is_inference():
        return cluster_walk(tables)
    kept = getattr(sph, "_cluster_walk", None)
    if kept is None or kept[0] != sph._version:
        kept = (sph._version, cluster_walk(tables))
        sph._cluster_walk = kept
    return kept[1]


def intersect_clustered_walk_plain(tables, walk: ClusterWalk, org, d, alive):
    """The walk of csrc/intersect_clustered.cu in plain PyTorch,
    CLUSTER_PLAIN_BLOCKS blocks at a time: per 1024-ray block the clusters
    that some live lane's cull test passes (the plain version's block
    decision); per warp (WARP consecutive lanes) those of them whose grown
    bound some lane, live or dead, may hit (bound_votes: a lane outside
    the proof votes for all); per lane the real slots of the clusters its
    warp enters, the first least candidate from (BIG, 0) in ascending slot
    order. Equals intersect_clustered_plain wherever the kernel's proofs
    hold. Returns (at, idx, hit, inv_a, stats): stats["surviving"] per block
    its surviving clusters, stats["entered"] per warp the clusters it
    enters, stats["pairs"] per warp the real pairs each of its lanes tests,
    stats["uncovered"] per lane whether it lies outside the proof."""
    sph, clus, perm = tables
    runs, bounds, _ = walk
    n, k = org.shape[0], clus.shape[1]
    dev = org.device
    o0, o1, o2 = org[:, 0], org[:, 1], org[:, 2]
    d0, d1, d2 = d[:, 0], d[:, 1], d[:, 2]
    od = o0 * d0 + o1 * d1 + o2 * d2
    oq = o0 * o0 + o1 * o1 + o2 * o2
    a = d0 * d0 + d1 * d1 + d2 * d2
    inv_a = 1.0 / a
    count = runs[:, 1].to(torch.int64)
    real = (torch.arange(CLUSTER, device=dev).repeat(k)
            < count.repeat_interleave(CLUSTER))  # (16 K,)
    votes = bound_votes(bounds, (o0, o1, o2), (d0, d1, d2), False)
    best_at = torch.empty_like(a)
    best_idx = torch.empty(n, dtype=torch.int64, device=dev)
    surviving = torch.empty(n // RAY_BLOCK, dtype=torch.int64, device=dev)
    entered_n = torch.empty(n // WARP, dtype=torch.int64, device=dev)
    pairs = torch.empty(n // WARP, dtype=torch.int64, device=dev)
    ccx, ccy, ccz, cr2 = (clus[c][None, :] for c in range(4))
    cx, cy, cz, a_s = (sph[c][None, :] for c in range(4))
    step = CLUSTER_PLAIN_BLOCKS * RAY_BLOCK
    per_blk = RAY_BLOCK // WARP
    for lo in range(0, n, step):
        sl = slice(lo, min(n, lo + step))
        nb = (sl.stop - sl.start) // RAY_BLOCK
        r0, r1, r2 = (x[sl, None] for x in (o0, o1, o2))
        e0, e1, e2 = (x[sl, None] for x in (d0, d1, d2))
        ra, rinv, rod, roq = (x[sl, None] for x in (a, inv_a, od, oq))
        # the block decision: the plain version's cull, per cluster
        fx, fy, fz = ccx - r0, ccy - r1, ccz - r2
        fb = fx * e0 + fy * e1 + fz * e2
        fq = fx * fx + fy * fy + fz * fz
        perp2 = fq - fb * fb * rinv
        may_hit = (((perp2 <= cr2) | (fq <= cr2))
                   & (fb >= -vec.sqrt(cr2 * ra)) & alive[sl, None])
        run = may_hit.reshape(nb, RAY_BLOCK, k).any(dim=1)  # (nb, K)
        # the warp skip over the surviving clusters
        entered = (votes[sl].reshape(nb * per_blk, WARP, k).any(dim=1)
                   & run.repeat_interleave(per_blk, dim=0))  # (warps, K)
        tested = (entered.repeat_interleave(WARP, dim=0)
                  .repeat_interleave(CLUSTER, dim=1) & real[None, :])
        # the pair test on every slot; untested slots give BIG
        bp = cx * e0 + cy * e1 + cz * e2 - rod
        g = a_s + 2.0 * (cx * r0 + cy * r1 + cz * r2) - roq
        disc = g + bp * bp * rinv
        sq = vec.sqrt(ra * disc)
        inside_pos = (g >= 0.0) & (bp >= 0.0)
        at = bp + torch.where(inside_pos, sq, -sq)
        cand = torch.where((disc >= 0.0) & (at >= 0.0) & tested, at, BIG)
        at_min, j = torch.min(cand, dim=1)
        best_at[sl] = at_min
        best_idx[sl] = torch.where(at_min < BIG, j, 0)
        surviving[lo // RAY_BLOCK:lo // RAY_BLOCK + nb] = run.sum(dim=1)
        ws = slice(lo // WARP, lo // WARP + nb * per_blk)
        entered_n[ws] = entered.sum(dim=1)
        pairs[ws] = (entered.long() * count[None, :]).sum(dim=1)
    uncovered = ~(torch.abs(a - 1.0) <= DIR_TOL) | ~(oq <= ORG_Q_MAX)
    stats = {"surviving": surviving, "entered": entered_n, "pairs": pairs,
             "uncovered": uncovered}
    return best_at, perm[best_idx], best_at < BIG, inv_a, stats


def clustered_smem_bytes(k: int, n_real: int) -> int:
    """Shared memory a CTA of csrc/intersect_clustered.cu takes: per
    cluster its cull word, grown bound (16 B each) and run (8 B), 16 B per
    real slot, and two mask words per 32 clusters. Within SMEM_MAX: K <= 784
    when every cluster holds CLUSTER real spheres (K = 178 and 531 real
    spheres, shirley's, take 15,664 B)."""
    return 40 * k + 16 * n_real + 8 * (-(-k // 32))


def intersect_clustered(tables, org, d, alive):
    """Nearest hit of N rays against the clustered tables of
    pack_spheres_clustered (the JAX intersect_clustered_pallas): the
    contract of intersect_spheres, with a per-1024-ray-block cull of each
    cluster by its bounding sphere. idx is an original sphere index (mapped
    through perm); a miss is (BIG, perm[0]). The kernel reads the tables'
    cached_cluster_walk beside them: host work at the first call on a
    sphere table, kept for the later ones.

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
    if k == 0:
        raise ValueError("intersect_clustered: want K > 0 clusters")
    runs, bounds, n_real = cached_cluster_walk(tables)
    smem = clustered_smem_bytes(k, n_real)
    if smem > SMEM_MAX:
        raise ValueError(f"intersect_clustered: {k} clusters with {n_real} "
                         f"real slots take {smem} B of shared memory, more "
                         f"than {SMEM_MAX} (K <= 784 with full clusters)")
    n = org.shape[0]
    lib = _build.load()
    at = torch.empty(n, dtype=torch.float32, device=org.device)
    idx = torch.empty(n, dtype=torch.int32, device=org.device)
    inv_a = torch.empty(n, dtype=torch.float32, device=org.device)
    err = lib.pt_intersect_clustered(
        sph.data_ptr(), clus.data_ptr(), k, bounds.data_ptr(),
        runs.data_ptr(), n_real, perm.data_ptr(), org.data_ptr(),
        d.data_ptr(), alive.data_ptr(), at.data_ptr(), idx.data_ptr(),
        inv_a.data_ptr(), n, torch.cuda.current_stream(org.device).cuda_stream)
    _build.check(lib, err, "intersect_clustered")
    intersect_clustered.launches += 1
    return at, idx, at < BIG, inv_a


intersect_clustered.launches = 0
