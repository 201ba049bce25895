"""The re-entry walks: nearest mesh hit per ray over the BVH8 or the BVH4
walk table of ops/bvh.py.

Port of the walks of pathtracer_tpu/ops/bvh.py:make_mesh_traverser_bvh8
and make_mesh_traverser_bvh4 (XLA while_loops there, not Pallas kernels).
`bvh8_walk` launches csrc/bvh8_walk.cu and `bvh4_walk` csrc/bvh4_walk.cu
for CUDA tensors, and each runs its plain version (`bvh8_walk_plain`,
`bvh4_walk_plain`: the JAX step in torch over all lanes) for CPU tensors.

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

__all__ = ["bvh4_walk", "bvh4_walk_plain", "bvh8_walk",
           "bvh8_walk_plain"]

# lanes of each kernel per ray, one child of a node row each
LANES_PER_RAY = 8
BVH4_LANES_PER_RAY = 4
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


def _mt_update(org, d, rows, rows_i, c, best, is_tri):
    """Moller-Trumbore against the triangle at row columns [c, c+9), index
    at column c+9, in the kernel's order; `is_tri` lanes accept t <= best."""
    tb, ub, vb, ib = best
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
    ok = (is_tri & (torch.abs(det) >= _EPS) & (uu >= 0.0) & (uu <= 1.0)
          & (vv >= 0.0) & (uu + vv <= 1.0) & (tt >= 0.0) & (tt <= tb))
    return (torch.where(ok, tt, tb), torch.where(ok, uu, ub),
            torch.where(ok, vv, vb), torch.where(ok, rows_i[:, c + 9], ib))


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


def _step4(table, table_i, node_end4: int, done: int, org, d, inv_d, state):
    """One step of the JAX BVH4 walk body on every given lane (the identity
    on a lane at the done pointer). state = (ptr, lret, t, u, v, idx)."""
    ptr, lret, *best = state
    dev = ptr.device
    iota4 = torch.arange(4, device=dev)
    rows = table[ptr >> 2]  # (n, 32): one row per lane and step
    rows_i = table_i[ptr >> 2]
    phase = ptr & 3
    is_node = ptr < node_end4

    # node: 4 world-space slab tests (a NaN pad box never hits)
    boxes = rows[:, 0:24].reshape(-1, 4, 6)
    t0 = (boxes[:, :, 0:3] - org[:, None, :]) * inv_d[:, None, :]
    t1 = (boxes[:, :, 3:6] - org[:, None, :]) * inv_d[:, None, :]
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    zero = torch.zeros((), device=dev)
    bh = torch.maximum(tn, zero) <= torch.minimum(tf, best[0][:, None])
    bh = bh & (iota4 >= phase[:, None])
    any_hit = bh.any(dim=1) & is_node
    sel = torch.where(bh, iota4, 4).amin(dim=1)
    sel = torch.where(sel == 4, 0, sel)
    e_sel = rows_i[:, 24:28].gather(1, sel[:, None])[:, 0].long()
    skp = rows_i[:, 28].long()
    nxt_node = torch.where(any_hit, e_sel, skp)
    # child sel's exit: this row at phase sel+1, the row's exit after the
    # last child
    exit_sel = torch.where(sel == rows_i[:, 29] - 1, skp,
                           (ptr & ~3) + sel + 1)

    # triangle pair: the first, then the second against the new best
    is_tri = ~is_node
    best = _mt_update(org, d, rows, rows_i, 0, best, is_tri)
    best = _mt_update(org, d, rows, rows_i, 12, best, is_tri)

    nxt_tri = torch.where(rows[:, 10] > 0.5, lret, ptr + 4)
    nxt = torch.where(is_node, nxt_node, nxt_tri)
    nxt = torch.where(ptr == done, done, nxt)
    lret = torch.where(is_node & any_hit & (e_sel >= node_end4),
                       exit_sel, lret)
    return (nxt, lret) + tuple(best)


def _walk_plain(what, step, phases: int, table, org, d, t_max0, active,
                node_end: int, stride: int, check_every: int,
                count_steps: bool):
    """The JAX walk with `step` (_step8 or _step4, pointers row * phases +
    phase) until no lane is live. Every `check_every` steps the live lanes
    are read on the host and only they step on (a step of a finished lane
    is the identity, so this changes no result). Returns (t, u, v, idx
    int32, hit); with count_steps also the steps each lane took, (N, 2)
    int64 [node rows, triangle-pair rows], and the (R,) bool mask of the
    table rows read (what a bound on the walk's work counts)."""
    _check(what, table, org, d, t_max0, active, contiguous=False)
    n, dev = org.shape[0], org.device
    row_shift = phases.bit_length() - 1
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
             torch.zeros(n, dtype=torch.int32, device=dev)]
    steps = torch.zeros(n, 2, dtype=torch.int64, device=dev)
    visited = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    while True:
        live = torch.nonzero(state[0] != done)[:, 0]
        if live.numel() == 0:
            break
        sub = tuple(x[live] for x in state)
        o, dd, idd = org[live], d[live], inv_d[live]
        for _ in range(check_every):
            if count_steps:
                p = sub[0]
                steps[live, 0] += p < node_end_p
                steps[live, 1] += (p >= node_end_p) & (p != done)
                visited[p[p != done] >> row_shift] = True
            sub = step(table, table_i, node_end_p, done, o, dd, idd, sub)
        for x, y in zip(state, sub):
            x[live] = y
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


def _launch(what, entry, lanes_per_ray, phases, table, org, d, t_max0,
            active, node_end, stride):
    """Check a walk's arguments for its kernel and launch it through
    `entry` (pt_bvh8_walk or pt_bvh4_walk). Returns (t, u, v, idx, hit)."""
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
        v.data_ptr(), idx.data_ptr(), hit.data_ptr(), n, lanes_per_ray,
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


def bvh4_walk(table, org, d, t_max0, active, node_end: int, stride: int):
    """Nearest mesh hit of N rays no farther than t_max0 over the BVH4
    walk table (R, 32) (the JAX MeshBVH.intersect of walk="bvh4"). org, d
    (N, 3) f32; t_max0 (N,) f32; active (N,) bool; node_end and stride in
    rows. Returns (t, u, v, idx int32, hit), each (N,).

    CPU tensors run bvh4_walk_plain; CUDA tensors launch csrc/bvh4_walk.cu
    with BVH4_LANES_PER_RAY lanes per ray (counted in
    `bvh4_walk.launches`); anything else raises."""
    if org.device.type == "cpu":
        return bvh4_walk_plain(table, org, d, t_max0, active, node_end,
                               stride)
    if org.device.type != "cuda":
        raise ValueError(f"bvh4_walk: no kernel for {org.device}")
    out = _launch("bvh4_walk", "pt_bvh4_walk", BVH4_LANES_PER_RAY, 4, table,
                  org, d, t_max0, active, node_end, stride)
    bvh4_walk.launches += 1
    return out


bvh4_walk.launches = 0
