"""The reference's own hierarchy over a triangle mesh and its nearest-hit
walk, in plain PyTorch.

The build sorts the triangles by the Morton code of their centroids, cuts
the sorted run into leaves of LEAF triangles, and stacks a complete binary
tree over the leaves (heap order: node i has children 2i + 1 and 2i + 2,
the leaves last), each node's box the union of its children's, widened by
a relative margin so that no rounding of the slab test loses a hit. It
shares nothing with the program's hierarchies but the triangles.

The walk keeps a stack of nodes and their entry distances per ray and pops
one node per ray per step, all live rays at once. A hit is a triangle whose
Moller-Trumbore test accepts (|det| >= 1e-6, 0 <= u <= 1, v >= 0,
u + v <= 1, t >= 0) with t below the ray's best so far, which starts at
the ray's own bound (the nearest sphere or floor hit), so the mesh wins
only where it is strictly nearer.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["LEAF", "MeshTree", "cross", "mt_test", "walk"]

LEAF = 4
DET_EPS = 1e-6
STACK = 64


def _morton(c: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points `c` (N, 3) scaled into [0, 1023]^3."""
    lo, hi = c.min(0), c.max(0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-30) * 1023.0).astype(np.int64)
    code = np.zeros(len(c), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + (2 - axis))
    return code


class MeshTree:
    """The tree over triangles (a, e1, e2), (M, 3) float64 each, with its
    arrays on `device` in `dtype`: `lo`, `hi` (nodes, 3) boxes, `valid`
    (nodes,) bool, `leaf_tri` (leaves, LEAF) triangle ids (-1 pads), and
    the triangles `a`, `e1`, `e2` with one zero row appended for the pads
    (its det is 0, so it never hits)."""

    def __init__(self, a, e1, e2, device, dtype):
        m = len(a)
        verts = np.stack([a, a + e1, a + e2], axis=1)  # (M, 3, 3)
        order = np.argsort(_morton(verts.mean(1)), kind="stable")
        n_leaf = max(1, -(-m // LEAF))
        leaves = 1 << (n_leaf - 1).bit_length()
        ids = np.full(leaves * LEAF, -1, np.int64)
        ids[:m] = order
        ids = ids.reshape(leaves, LEAF)
        fill = lambda x: np.concatenate([verts, np.full((1, 3, 3), x)])[ids]
        leaf_lo = fill(np.inf).reshape(leaves, -1, 3).min(1)
        leaf_hi = fill(-np.inf).reshape(leaves, -1, 3).max(1)
        n = 2 * leaves - 1
        lo = np.empty((n, 3))
        hi = np.empty((n, 3))
        lo[leaves - 1:], hi[leaves - 1:] = leaf_lo, leaf_hi
        first = leaves - 1
        while first > 0:  # one level up: nodes [first/2 - ..., first)
            top = (first - 1) // 2
            kids_lo, kids_hi = lo[first:2 * first + 1], hi[first:2 * first + 1]
            lo[top:first] = np.minimum(kids_lo[0::2], kids_lo[1::2])
            hi[top:first] = np.maximum(kids_hi[0::2], kids_hi[1::2])
            first = top
        valid = (lo <= hi).all(1)
        lo, hi = np.where(valid[:, None], lo, 0.0), np.where(valid[:, None],
                                                             hi, 0.0)
        pad = 1e-7 * (np.abs(lo) + np.abs(hi))
        lo, hi = lo - pad, hi + pad
        t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        self.n_inner = leaves - 1
        self.lo, self.hi = t(lo), t(hi)
        self.valid = torch.as_tensor(valid, device=device)
        self.leaf_tri = torch.as_tensor(ids, device=device)
        zero = np.zeros((1, 3))
        self.a = t(np.concatenate([a, zero]))
        self.e1 = t(np.concatenate([e1, zero]))
        self.e2 = t(np.concatenate([e2, zero]))


def cross(a, b):
    """a x b over the last axis, with broadcasting."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def mt_test(o, d, a, e1, e2):
    """Moller-Trumbore of rays o, d (..., 3) against triangles a, e1, e2
    (..., 3), broadcast. Returns (ok, t, u, v)."""
    pv = cross(d, e2)
    det = (e1 * pv).sum(-1)
    inv = 1.0 / det
    tv = o - a
    u = (tv * pv).sum(-1) * inv
    qv = cross(tv, e1)
    v = (d * qv).sum(-1) * inv
    t = (e2 * qv).sum(-1) * inv
    ok = ((det.abs() >= DET_EPS) & (u >= 0) & (u <= 1) & (v >= 0)
          & (u + v <= 1) & (t >= 0))
    return ok, t, u, v


def _slab(o, inv, lo, hi):
    """Entry and exit distances of rays (n, 3) into boxes (n, 3)."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    near = torch.minimum(t0, t1).amax(-1).clamp(min=0.0)
    far = torch.maximum(t0, t1).amin(-1)
    return near, far


def walk(tree: MeshTree, o, d, t_best, max_steps: int | None = None):
    """Nearest mesh hit of rays o, d (n, 3) below t_best (n,). Returns
    (hit (n,) bool, t, u, v, triangle id (n,) int64). max_steps bounds the
    walk (the bfloat16 control, whose boxes may let a ray visit most of
    the tree); None walks every ray to its end."""
    n = o.shape[0]
    dev = o.device
    tiny = torch.finfo(d.dtype).tiny
    d_safe = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
    inv = 1.0 / d_safe
    best_t = t_best.clone()
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_id = torch.full((n,), -1, dtype=torch.int64, device=dev)
    stack = torch.zeros(n, STACK, dtype=torch.int64, device=dev)
    stack_t = torch.zeros(n, STACK, dtype=o.dtype, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    act = torch.arange(n, device=dev)
    steps = 0
    while act.numel():
        steps += 1
        if max_steps is not None and steps > max_steps:
            break
        top = sp[act] - 1
        node = stack[act, top]
        near = stack_t[act, top]
        sp[act] = top
        keep = near <= best_t[act]
        popped = act
        act, node = act[keep], node[keep]
        leaf = node >= tree.n_inner
        la = act[leaf]
        if la.numel():
            ids = tree.leaf_tri[node[leaf] - tree.n_inner]  # (k, LEAF)
            ids_safe = torch.where(ids < 0, tree.a.shape[0] - 1, ids)
            ok, t, u, v = mt_test(o[la, None], d[la, None], tree.a[ids_safe],
                                  tree.e1[ids_safe], tree.e2[ids_safe])
            t = torch.where(ok, t, torch.full_like(t, float("inf")))
            t_min, j = t.min(1)
            better = t_min < best_t[la]
            lb = la[better]
            jb = j[better, None]
            best_t[lb] = t_min[better]
            best_u[lb] = u[better].gather(1, jb)[:, 0]
            best_v[lb] = v[better].gather(1, jb)[:, 0]
            best_id[lb] = ids[better].gather(1, jb)[:, 0]
        ia = act[~leaf]
        if ia.numel():
            kids = 2 * node[~leaf, None] + torch.tensor([1, 2], device=dev)
            oi, vi = o[ia, None], inv[ia, None]
            near, far = _slab(oi, vi, tree.lo[kids], tree.hi[kids])
            enter = (tree.valid[kids] & (near <= far)
                     & (near <= best_t[ia, None]))
            # push the farther child first, so the nearer one pops next
            swap = near[:, 1] < near[:, 0]
            first = torch.where(swap, 0, 1)
            for col in (first, 1 - first):
                go = enter.gather(1, col[:, None])[:, 0]
                ra = ia[go]
                pos = sp[ra]
                stack[ra, pos] = kids[go].gather(1, col[go, None])[:, 0]
                stack_t[ra, pos] = near[go].gather(1, col[go, None])[:, 0]
                sp[ra] = pos + 1
        act = popped[sp[popped] > 0]
    hit = best_id >= 0
    return hit, best_t, best_u, best_v, best_id
