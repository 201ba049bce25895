"""Nearest-hit ray/sphere-set intersection: the sphere table and the plain
PyTorch versions of the in-kernel intersection loops.

Port of pathtracer_tpu/ops/pallas/sphere_kernel.py (pack_spheres_pallas,
intersect_regs, intersect_regs_listed). On the card this math runs inside the
fused bounce kernel (csrc/fused_bounce.cu); the functions here are its plain
version, used for CPU tensors and as the yardstick on the card.

Selection semantics, kept exactly:
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

BIG = float(np.float32(3.0e38))
RAY_BLOCK = 1024  # rays per block: one 32x32 image tile at bounce 0
LANES = 128
LIST_UNROLL = 8  # per-block sphere lists are padded to a multiple of this
# rays per chunk of the plain version: bounds its (rays, spheres) temporaries
PLAIN_CHUNK = 8 * RAY_BLOCK


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
    sq = torch.sqrt(disc)
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
