"""The re-entry walks: nearest mesh hit per ray over the BVH8 or the BVH4
walk table of ops/bvh.py.

Port of the walks of pathtracer_tpu/ops/bvh.py:make_mesh_traverser_bvh8
and make_mesh_traverser_bvh4 (XLA while_loops there, not Pallas kernels).
`bvh8_walk` launches csrc/bvh8_walk.cu and `bvh4_walk` csrc/bvh4_walk.cu
for CUDA tensors, and each runs its plain version (`bvh8_walk_plain`,
`bvh4_walk_plain`: the JAX step in torch over all lanes) for CPU tensors.
`bvh4_walk_cached_plain` emulates csrc/bvh4_walk.cu's steps (its path
cache of node rows, its leaf step over two pair rows) and counts them.

Semantics of the JAX walks, kept exactly:
- a lane starts at its direction octant's root row, oct * W * stride with
  oct = (dx<0)<<2 | (dy<0)<<1 | (dz<0) and W = 8 (BVH8) or 4 (BVH4)
  pointer phases a row, when active, else at the done pointer W * (R - 1);
  t starts at min(t_max0, BIG) and hit = t < min(t_max0, BIG);
- a node row's child k hits when max(tn, 0) <= min(tf, t) and k >= phase
  (BVH8: in the row's quantized frame, and k < arity; BVH4: the child's
  world-space box, NaN past the arity); min and max propagate NaN, so the
  NaN of 0 * inf (an axis-aligned ray on a box plane) or of a pad box is
  a miss;
- the first hitting child is entered; a leaf child records the re-entry
  pointer (BVH8: this row at phase sel+1 if a later child hits, else the
  exit; BVH4: the exit if sel is the last child, else this row at phase
  sel+1);
- BVH8's 24-bit entries are unpacked with logical shifts;
- a triangle-pair row (one format in both tables) accepts t <= best (not
  strict), first then second.
The JAX walks' coherence sort, chunks and step caps are dropped: a lane's
result does not depend on them.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _build
from .sphere_kernel import BIG

__all__ = ["bvh4_walk", "bvh4_walk_cached_plain", "bvh4_walk_plain",
           "bvh8_walk", "bvh8_walk_plain"]

# lanes of each kernel per ray, one child of a node row each
LANES_PER_RAY = 8
BVH4_LANES_PER_RAY = 4
# node rows of csrc/bvh4_walk.cu's per-ray path cache (its K, which the
# library reports and bvh4_walk checks)
BVH4_CACHE_ROWS = 4
_EPS = float(np.float32(1e-6))
_SHIFTS = (0, 8, 16, 24)


def _check(what, table, org, d, t_max0, active, contiguous: bool):
    """A walk wrapper's contract (contiguity for the kernel only)."""
    n = org.shape[0]
    ok = (table.dim() == 2 and table.shape[1] == 32
          and table.dtype == torch.float32 and org.dim() == 2
          and org.shape[1] == 3 and org.dtype == d.dtype == torch.float32
          and tuple(d.shape) == tuple(org.shape)
          and t_max0.dtype == torch.float32 and tuple(t_max0.shape) == (n,)
          and active.dtype == torch.bool and tuple(active.shape) == (n,)
          and all(x.device == org.device
                  and (x.is_contiguous() or not contiguous)
                  for x in (table, org, d, t_max0, active)))
    if not ok:
        raise ValueError(
            f"{what}: want a contiguous f32 (R, 32) table, org, d (N, 3) "
            "f32, t_max0 (N,) f32 and active (N,) bool on one device; got "
            f"table {tuple(table.shape)} {table.dtype}, org "
            f"{tuple(org.shape)} {org.dtype} {org.device}, t_max0 "
            f"{tuple(t_max0.shape)}, active {tuple(active.shape)} "
            f"{active.dtype}")


def _mt_test(org, d, rows, rows_i, c, tb):
    """Moller-Trumbore against the triangle at row columns [c, c+9), index
    at column c+9, in the kernel's order: (accepts with t <= tb, t, u, v,
    index)."""
    ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = rows[:, c:c + 9].unbind(1)
    o0, o1, o2 = org.unbind(1)
    d0, d1, d2 = d.unbind(1)
    pvx = d1 * e2z - d2 * e2y  # pvec = d x e2
    pvy = d2 * e2x - d0 * e2z
    pvz = d0 * e2y - d1 * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_inv = 1.0 / det
    tvx, tvy, tvz = o0 - ax, o1 - ay, o2 - az
    uu = det_inv * (tvx * pvx + tvy * pvy + tvz * pvz)
    qvx = tvy * e1z - tvz * e1y  # qvec = tvec x e1
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vv = det_inv * (d0 * qvx + d1 * qvy + d2 * qvz)
    tt = det_inv * (e2x * qvx + e2y * qvy + e2z * qvz)
    ok = ((torch.abs(det) >= _EPS) & (uu >= 0.0) & (uu <= 1.0)
          & (vv >= 0.0) & (uu + vv <= 1.0) & (tt >= 0.0) & (tt <= tb))
    return ok, tt, uu, vv, rows_i[:, c + 9]


def _mt_update(org, d, rows, rows_i, c, best, is_tri):
    """_mt_test against the best t, u, v, idx; `is_tri` lanes take the
    triangle where it accepts (t <= best)."""
    tb, ub, vb, ib = best
    ok, tt, uu, vv, ii = _mt_test(org, d, rows, rows_i, c, tb)
    ok = ok & is_tri
    return (torch.where(ok, tt, tb), torch.where(ok, uu, ub),
            torch.where(ok, vv, vb), torch.where(ok, ii, ib))


def _step8(table, table_i, node_end8: int, done: int, org, d, inv_d,
           state):
    """One step of the JAX BVH8 walk body on every given lane (the
    identity on a lane at the done pointer). state = (ptr, lret, t, u, v,
    idx)."""
    ptr, lret, *best = state
    n, dev = ptr.shape[0], ptr.device
    iota8 = torch.arange(8, device=dev)
    rows = table[ptr >> 3]  # (n, 32): one row per lane and step
    rows_i = table_i[ptr >> 3]
    phase = ptr & 7
    is_node = ptr < node_end8

    # node: slab tests in the row's quantized frame
    w = rows_i[:, 6:18].long() & 0xFFFFFFFF
    shifts = torch.tensor(_SHIFTS, device=dev)
    qs = ((w[:, :, None] >> shifts) & 0xFF).reshape(n, 48).float()
    qlo = qs[:, 0::2].reshape(n, 8, 3)
    qhi = qs[:, 1::2].reshape(n, 8, 3)
    po = (org - rows[:, 0:3]) * rows[:, 26:29]
    idp = inv_d * rows[:, 3:6]
    t0 = (qlo - po[:, None, :]) * idp[:, None, :]
    t1 = (qhi - po[:, None, :]) * idp[:, None, :]
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    zero = torch.zeros((), device=dev)
    bh = torch.maximum(tn, zero) <= torch.minimum(tf, best[0][:, None])
    bh = bh & (iota8 >= phase[:, None]) & (iota8 < rows_i[:, 25, None])
    any_hit = bh.any(dim=1) & is_node
    sel = torch.where(bh, iota8, 8).amin(dim=1)
    sel = torch.where(sel == 8, 0, sel)

    # the 24-bit entries, logical shifts on the unsigned words
    w24 = rows_i[:, 18:24].long() & 0xFFFFFFFF
    entries = []
    for i in range(8):
        c, sh = (3 * i) >> 2, ((3 * i) & 3) * 8
        v = w24[:, c] >> sh
        if sh > 8:
            v = v | (w24[:, c + 1] << (32 - sh))
        entries.append(v & 0xFFFFFF)
    raw = torch.stack(entries, dim=1).gather(1, sel[:, None])[:, 0]
    e_sel = raw & ~7
    skp = rows_i[:, 24].long()
    nxt_node = torch.where(any_hit, e_sel, skp)
    beyond = (bh & (iota8 > sel[:, None])).any(dim=1)
    exit_sel = torch.where(beyond, (ptr & ~7) + sel + 1, skp)

    # triangle pair: the first, then the second against the new best
    is_tri = ~is_node
    best = _mt_update(org, d, rows, rows_i, 0, best, is_tri)
    best = _mt_update(org, d, rows, rows_i, 12, best, is_tri)

    nxt_tri = torch.where(rows[:, 10] > 0.5, lret, ptr + 8)
    nxt = torch.where(is_node, nxt_node, nxt_tri)
    nxt = torch.where(ptr == done, done, nxt)
    lret = torch.where(is_node & any_hit & (e_sel >= node_end8),
                       exit_sel, lret)
    return (nxt, lret) + tuple(best)


def _node4(rows, rows_i, ptr, org, inv_d, tb, node_end4: int):
    """A BVH4 node row's step for lanes at pointer ptr with best t tb:
    (the next pointer, the leaf-return pointer where a leaf child is
    entered, whether one is)."""
    dev = ptr.device
    iota4 = torch.arange(4, device=dev)
    phase = ptr & 3
    # 4 world-space slab tests (a NaN pad box never hits)
    boxes = rows[:, 0:24].reshape(-1, 4, 6)
    t0 = (boxes[:, :, 0:3] - org[:, None, :]) * inv_d[:, None, :]
    t1 = (boxes[:, :, 3:6] - org[:, None, :]) * inv_d[:, None, :]
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    zero = torch.zeros((), device=dev)
    bh = torch.maximum(tn, zero) <= torch.minimum(tf, tb[:, None])
    bh = bh & (iota4 >= phase[:, None])
    any_hit = bh.any(dim=1)
    sel = torch.where(bh, iota4, 4).amin(dim=1)
    sel = torch.where(sel == 4, 0, sel)
    e_sel = rows_i[:, 24:28].gather(1, sel[:, None])[:, 0].long()
    skp = rows_i[:, 28].long()
    nxt = torch.where(any_hit, e_sel, skp)
    # child sel's exit: this row at phase sel+1, the row's exit after the
    # last child
    exit_sel = torch.where(sel == rows_i[:, 29] - 1, skp,
                           (ptr & ~3) + sel + 1)
    return nxt, exit_sel, any_hit & (e_sel >= node_end4)


def _step4(table, table_i, node_end4: int, done: int, org, d, inv_d, state):
    """One step of the JAX BVH4 walk body on every given lane (the identity
    on a lane at the done pointer). state = (ptr, lret, t, u, v, idx)."""
    ptr, lret, *best = state
    rows = table[ptr >> 2]  # (n, 32): one row per lane and step
    rows_i = table_i[ptr >> 2]
    is_node = ptr < node_end4
    nxt_node, exit_sel, enter_leaf = _node4(rows, rows_i, ptr, org, inv_d,
                                            best[0], node_end4)

    # triangle pair: the first, then the second against the new best
    is_tri = ~is_node
    best = _mt_update(org, d, rows, rows_i, 0, best, is_tri)
    best = _mt_update(org, d, rows, rows_i, 12, best, is_tri)

    nxt_tri = torch.where(rows[:, 10] > 0.5, lret, ptr + 4)
    nxt = torch.where(is_node, nxt_node, nxt_tri)
    nxt = torch.where(ptr == done, done, nxt)
    lret = torch.where(is_node & enter_leaf, exit_sel, lret)
    return (nxt, lret) + tuple(best)


def _walk(what, step, phases: int, table, org, d, t_max0, active,
          node_end: int, stride: int, check_every: int, extra=(),
          on_steps=None):
    """The JAX walk with `step` (_step8, _step4 or _cached_step4, pointers
    row * phases + phase) until no lane is live. The state is (ptr, lret,
    t, u, v, idx) and the tensors of `extra`, one row per lane. Every
    `check_every` steps the live lanes are read on the host and only they
    step on (a step of a finished lane is the identity, so this changes no
    result); on_steps(live, state) sees each step's live lanes before it.
    Returns (t_lim, the final state)."""
    _check(what, table, org, d, t_max0, active, contiguous=False)
    n, dev = org.shape[0], org.device
    done = phases * (table.shape[0] - 1)
    node_end_p = phases * node_end
    table_i = table.view(torch.int32)
    inv_d = 1.0 / d
    oct_ = ((d[:, 0] < 0.0).long() * 4 + (d[:, 1] < 0.0).long() * 2
            + (d[:, 2] < 0.0).long())
    ptr = torch.where(active, oct_ * (phases * stride), done)
    t_lim = torch.minimum(t_max0, torch.tensor(BIG, device=dev))
    state = [ptr, torch.full_like(ptr, done), t_lim.clone(),
             torch.zeros_like(t_lim),
             torch.zeros_like(t_lim),
             torch.zeros(n, dtype=torch.int32, device=dev), *extra]
    while True:
        live = torch.nonzero(state[0] != done)[:, 0]
        if live.numel() == 0:
            break
        sub = tuple(x[live] for x in state)
        o, dd, idd = org[live], d[live], inv_d[live]
        for _ in range(check_every):
            if on_steps is not None:
                on_steps(live, sub)
            sub = step(table, table_i, node_end_p, done, o, dd, idd, sub)
        for x, y in zip(state, sub):
            x[live] = y
    return t_lim, state


def _walk_plain(what, step, phases: int, table, org, d, t_max0, active,
                node_end: int, stride: int, check_every: int,
                count_steps: bool):
    """The JAX walk with `step` (_step8 or _step4) on every lane (_walk).
    Returns (t, u, v, idx int32, hit); with count_steps also the steps
    each lane took, (N, 2) int64 [node rows, triangle-pair rows], and the
    (R,) bool mask of the table rows read (what a bound on the walk's work
    counts)."""
    dev = org.device
    row_shift = phases.bit_length() - 1
    done, node_end_p = phases * (table.shape[0] - 1), phases * node_end
    steps = torch.zeros(org.shape[0], 2, dtype=torch.int64, device=dev)
    visited = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)

    def count(live, sub):
        p = sub[0]
        steps[live, 0] += p < node_end_p
        steps[live, 1] += (p >= node_end_p) & (p != done)
        visited[p[p != done] >> row_shift] = True

    t_lim, state = _walk(what, step, phases, table, org, d, t_max0, active,
                         node_end, stride, check_every,
                         on_steps=count if count_steps else None)
    t, u, v, idx = state[2:]
    out = (t, u, v, idx, t < t_lim)
    return out + (steps, visited) if count_steps else out


def bvh8_walk_plain(table, org, d, t_max0, active, node_end: int,
                    stride: int, check_every: int = 8,
                    count_steps: bool = False):
    """Plain PyTorch version of bvh8_walk: the JAX BVH8 walk step until no
    lane is live (_walk_plain: the returns, and the step counts and rows
    read of count_steps)."""
    return _walk_plain("bvh8_walk", _step8, 8, table, org, d, t_max0,
                       active, node_end, stride, check_every, count_steps)


def bvh4_walk_plain(table, org, d, t_max0, active, node_end: int,
                    stride: int, check_every: int = 8,
                    count_steps: bool = False):
    """Plain PyTorch version of bvh4_walk: the JAX BVH4 walk step until no
    lane is live (_walk_plain: the returns, and the step counts and rows
    read of count_steps)."""
    return _walk_plain("bvh4_walk", _step4, 4, table, org, d, t_max0,
                       active, node_end, stride, check_every, count_steps)


def _leaf_quad(org, d, pair, best):
    """csrc/bvh4_walk.cu's leaf step on two triangle-pair rows pair (n, 2,
    32): its four triangles tested against the best (t, u, v, idx) before
    the step, the second row's only where the first is not the leaf's
    last, combined as bvh_walk.cuh's tri_quad (the latest accepted
    triangle of least t). Returns (the new best, last0, last1)."""
    tb, ub, vb, ib = best
    last0, last1 = pair[:, 0, 10] > 0.5, pair[:, 1, 10] > 0.5
    tests = [_mt_test(org, d, pair[:, j >> 1],
                      pair[:, j >> 1].view(torch.int32), 12 * (j & 1), tb)
             for j in range(4)]
    inf = torch.tensor(float("inf"), device=org.device)
    key = torch.stack([torch.where(ok & ~last0 if j >= 2 else ok, tt, inf)
                       for j, (ok, tt, *_) in enumerate(tests)], dim=1)
    k_min = key.amin(dim=1)
    win = 3 - torch.flip(key == k_min[:, None], [1]).int().argmax(dim=1)
    take = k_min < inf
    uu, vv, ii = (torch.stack([x[c] for x in tests], dim=1)
                  .gather(1, win[:, None])[:, 0] for c in (2, 3, 4))
    return (torch.where(take, k_min, tb), torch.where(take, uu, ub),
            torch.where(take, vv, vb), torch.where(take, ii, ib)), last0, last1


def _cached_step4(table, table_i, node_end4: int, done: int, org, d,
                  inv_d, state):
    """One step of csrc/bvh4_walk.cu on every given lane (the identity on a
    lane at the done pointer): a node row from the path cache or the table,
    or a leaf's next two triangle-pair rows. state = (ptr, lret, t, u, v,
    idx, top, cnt, tags (n, K), rows (n, K, 32), counts (n, 4)); see
    bvh4_walk_cached_plain."""
    ptr, lret, tb, ub, vb, ib, top, cnt, tags, cached, counts = state
    n, k = tags.shape
    dev = ptr.device
    lanes = torch.arange(n, device=dev)
    row = ptr >> 2
    live = ptr != done
    is_node = ptr < node_end4
    is_leaf = live & ~is_node

    # a node row at phase > 0 is looked up in the cache's cnt newest slots:
    # a hit pops the slots above it, a miss empties the cache (every row in
    # it lies below the missed one on the ray's path)
    slots = torch.arange(k, device=dev)
    back = is_node & ((ptr & 3) > 0)
    newest = ((top[:, None] - slots) & (k - 1)) < cnt[:, None]
    match = back[:, None] & newest & (tags == row[:, None])
    hit = match.any(dim=1)
    slot = torch.where(match, slots, k).amin(dim=1)
    cnt = torch.where(hit, cnt - ((top - slot) & (k - 1)), cnt)
    top = torch.where(hit, slot, top)
    miss = back & ~hit
    cnt = torch.where(miss, 0, cnt)
    # any other node row is read from the table and pushed, the oldest
    # slot dropped when the cache is full
    push = is_node & ~hit
    top = torch.where(push, (top + 1) & (k - 1), top)
    cnt = torch.where(push, torch.clamp(cnt + 1, max=k), cnt)
    pl = lanes[push]
    tags[pl, top[pl]] = row[pl]
    cached[pl, top[pl]] = table[row[pl]]
    rows = cached[lanes, top]
    nxt_node, exit_sel, enter_leaf = _node4(
        rows, rows.view(torch.int32), ptr, org, inv_d, tb, node_end4)

    # a leaf's rows two at a time
    pair = torch.stack([table[row],
                        table[torch.clamp(row + 1, max=table.shape[0] - 1)]],
                       dim=1)
    (t_l, u_l, v_l, i_l), last0, last1 = _leaf_quad(org, d, pair,
                                                    (tb, ub, vb, ib))
    tb = torch.where(is_leaf, t_l, tb)
    ub = torch.where(is_leaf, u_l, ub)
    vb = torch.where(is_leaf, v_l, vb)
    ib = torch.where(is_leaf, i_l, ib)

    nxt_leaf = torch.where(last0 | last1, lret, ptr + 8)
    nxt = torch.where(is_node, nxt_node, nxt_leaf)
    nxt = torch.where(live, nxt, done)
    lret = torch.where(is_node & enter_leaf, exit_sel, lret)
    counts = counts + torch.stack(
        [push | is_leaf, hit, miss, is_leaf & ~last0], dim=1)
    return nxt, lret, tb, ub, vb, ib, top, cnt, tags, cached, counts


def bvh4_walk_cached_plain(table, org, d, t_max0, active, node_end: int,
                           stride: int, check_every: int = 8):
    """Plain emulation of csrc/bvh4_walk.cu's walk: the same results as
    bvh4_walk_plain, step by step as the kernel takes them. A ray keeps
    the last BVH4_CACHE_ROWS node rows it read from the table (the
    kernel's K) in a LIFO path cache with their row indices as tags, and
    reads a node row at phase > 0 from there where it can; a leaf's
    triangle-pair rows are tested two at a time, four triangles against
    the best before them.
    Returns (t, u, v, idx int32, hit, counts): counts (N, 4) int64 per
    lane [steps that read the table (a node row not in the cache, or a
    leaf's next rows): the chain of dependent loads, and the kernel's loop
    iterations; node rows at phase > 0 read from the cache; node rows at
    phase > 0 not in it; leaf steps that test two rows]."""
    n, dev = org.shape[0], org.device
    k = BVH4_CACHE_ROWS
    extra = (torch.zeros(n, dtype=torch.int64, device=dev),
             torch.zeros(n, dtype=torch.int64, device=dev),
             torch.full((n, k), -1, dtype=torch.int64, device=dev),
             torch.zeros(n, k, table.shape[1], dtype=table.dtype,
                         device=dev),
             torch.zeros(n, 4, dtype=torch.int64, device=dev))
    t_lim, state = _walk("bvh4_walk", _cached_step4, 4, table, org, d,
                         t_max0, active, node_end, stride, check_every,
                         extra=extra)
    t, u, v, idx = state[2:6]
    return t, u, v, idx, t < t_lim, state[-1]


def _launch(what, entry, lanes_per_ray, phases, table, org, d, t_max0,
            active, node_end, stride, extra=()):
    """Check a walk's arguments for its kernel and launch it through
    `entry` (pt_bvh8_walk or pt_bvh4_walk; `extra`: the entry's arguments
    after the hit pointer, before the lane count). Returns (t, u, v, idx,
    hit)."""
    _check(what, table, org, d, t_max0, active, contiguous=True)
    if table.data_ptr() % 16:
        raise ValueError(f"{what}: table must be 16-byte aligned (the "
                         "kernel reads its rows as float4)")
    if phases * table.shape[0] >= 1 << 31:
        raise ValueError(f"{what}: {table.shape[0]} rows are past the "
                         "kernel's int32 pointers")
    n = org.shape[0]
    lib = _build.load()
    t = torch.empty(n, dtype=torch.float32, device=org.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    idx = torch.empty(n, dtype=torch.int32, device=org.device)
    hit = torch.empty(n, dtype=torch.bool, device=org.device)
    err = getattr(lib, entry)(
        table.data_ptr(), phases * node_end, stride,
        phases * (table.shape[0] - 1), org.data_ptr(), d.data_ptr(),
        t_max0.data_ptr(), active.data_ptr(), t.data_ptr(), u.data_ptr(),
        v.data_ptr(), idx.data_ptr(), hit.data_ptr(), *extra, n,
        lanes_per_ray,
        torch.cuda.current_stream(org.device).cuda_stream)
    _build.check(lib, err, what)
    return t, u, v, idx, hit


def bvh8_walk(table, org, d, t_max0, active, node_end: int, stride: int):
    """Nearest mesh hit of N rays no farther than t_max0 over the BVH8
    walk table (R, 32) (the JAX MeshBVH.intersect of walk="bvh8"). org, d
    (N, 3) f32; t_max0 (N,) f32; active (N,) bool; node_end and stride in
    rows. Returns (t, u, v, idx int32, hit), each (N,).

    CPU tensors run bvh8_walk_plain; CUDA tensors launch csrc/bvh8_walk.cu
    with LANES_PER_RAY lanes per ray (counted in `bvh8_walk.launches`);
    anything else raises."""
    if org.device.type == "cpu":
        return bvh8_walk_plain(table, org, d, t_max0, active, node_end,
                               stride)
    if org.device.type != "cuda":
        raise ValueError(f"bvh8_walk: no kernel for {org.device}")
    out = _launch("bvh8_walk", "pt_bvh8_walk", LANES_PER_RAY, 8, table, org,
                  d, t_max0, active, node_end, stride)
    bvh8_walk.launches += 1
    return out


bvh8_walk.launches = 0


def bvh4_walk(table, org, d, t_max0, active, node_end: int, stride: int,
              counts):
    """Nearest mesh hit of N rays no farther than t_max0 over the BVH4
    walk table (R, 32) (the JAX MeshBVH.intersect of walk="bvh4"). org, d
    (N, 3) f32; t_max0 (N,) f32; active (N,) bool; node_end and stride in
    rows. Returns (t, u, v, idx int32, hit), each (N,).

    counts is a (2,) int64 tensor on the rays' device that the walk adds
    to: [0] the active rays walked, [1] their table loads (the kernel's
    loop iterations, bvh4_walk_cached_plain's table loads; the plain walk
    on the CPU counts none).

    CPU tensors run bvh4_walk_plain; CUDA tensors launch csrc/bvh4_walk.cu
    with BVH4_LANES_PER_RAY lanes per ray (counted in
    `bvh4_walk.launches`); anything else raises."""
    if org.device.type == "cpu":
        out = bvh4_walk_plain(table, org, d, t_max0, active, node_end,
                              stride)
        _check_counts(counts, org.device)
        counts[0] += active.sum()
        return out
    if org.device.type != "cuda":
        raise ValueError(f"bvh4_walk: no kernel for {org.device}")
    _check_counts(counts, org.device)
    k = _build.load().pt_bvh4_cache_rows()
    if k != BVH4_CACHE_ROWS:
        raise RuntimeError(f"bvh4_walk: the kernel's path cache holds {k} "
                           f"rows, BVH4_CACHE_ROWS says {BVH4_CACHE_ROWS}")
    out = _launch("bvh4_walk", "pt_bvh4_walk", BVH4_LANES_PER_RAY, 4, table,
                  org, d, t_max0, active, node_end, stride,
                  (counts.data_ptr(),))
    bvh4_walk.launches += 1
    return out


def _check_counts(counts, device):
    """bvh4_walk's counters: a contiguous (2,) int64 tensor on `device`."""
    if not (isinstance(counts, torch.Tensor) and counts.dtype == torch.int64
            and tuple(counts.shape) == (2,) and counts.device == device
            and counts.is_contiguous()):
        got = (f"{tuple(counts.shape)} {counts.dtype} {counts.device}"
               if isinstance(counts, torch.Tensor) else repr(counts))
        raise ValueError(f"bvh4_walk: counts must be a contiguous (2,) "
                         f"int64 tensor on {device}, got {got}")


bvh4_walk.launches = 0
