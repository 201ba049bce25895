"""Nearest-hit ray/sphere-set intersection: the sphere table, the plain
PyTorch versions of the in-kernel intersection loops, and the standalone
nearest-sphere kernel of the photon mapper.

Port of pathtracer_tpu/ops/pallas/sphere_kernel.py (pack_spheres_pallas,
intersect_regs, intersect_regs_listed, intersect_spheres_pallas). On the card
the intersect_regs math runs inside the fused bounce kernel
(csrc/fused_bounce.cu); intersect_spheres launches csrc/intersect_spheres.cu
for CUDA tensors and runs intersect_spheres_plain for CPU tensors.

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

from ... import _build
from .. import vec

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
