"""Nearest-hit ray/triangle-pool intersection (Moller-Trumbore).

Port of pathtracer_tpu/ops/pallas/tri_kernel.py (pack_tris_pallas,
intersect_tris_pallas). `intersect_tris` launches the CUDA kernel
csrc/intersect_tris.cu for CUDA tensors; `intersect_tris_plain` is the same
function in plain PyTorch, which `intersect_tris` runs for CPU tensors and
which the tests and chip_smoke.py hold the kernel against.

Semantics of the JAX kernel, kept exactly: |det| < 1e-6 misses; accept
0 <= u <= 1, v >= 0, u+v <= 1, t >= 0; a strict running minimum over the
triangles in table order, so ties go to the lowest index; padding triangles
have e1 = e2 = 0 (det == 0) and never hit; a 1024-ray block with no live ray
returns (BIG, 0).

The kernel walks only the columns with a nonzero edge component and runs a
division-free pre-reject before the full test of each pair; its header
proves that neither drops a pair the full test accepts. `tri_pair_stages`
and `tri_pair_tests` repeat both in plain PyTorch, for the tests and
chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _build
from .sphere_kernel import BIG, RAY_BLOCK, check_rays

__all__ = ["pack_tris", "intersect_tris", "intersect_tris_plain",
           "tri_pair_stages", "tri_pair_tests"]

_EPS = float(np.float32(1e-6))
# the kernel's pre-reject (csrc/intersect_tris.cu): largest |det| it runs
# at, the margin below 0 and the factors over |det| for u > 1, u + v > 1
_REGULAR = 2.0 ** 64
_TINY = 2.0 ** -64
_M1 = 1.0 + 2.0 ** -20
_M2 = 1.0 + 2.0 ** -18
# where the kernel leaves a pair (tri_pair_stages): a column it does not
# stage, the |det| test, the u tests, the v, t and u + v tests, the full test
PAD, AT_DET, AT_U, AT_VT, FULL = range(5)


def pack_tris(a, e1, e2, valid) -> torch.Tensor:
    """(9, T) f32 triangle table [a, e1, e2 by component]; invalid rows get
    e1 = e2 = 0."""
    v = valid[:, None]
    e1 = torch.where(v, e1, 0.0)
    e2 = torch.where(v, e2, 0.0)
    return torch.cat([a.T, e1.T, e2.T]).to(torch.float32).contiguous()


def intersect_tris_plain(table, org, d, alive):
    """Plain PyTorch version of intersect_tris, in the JAX kernel's order of
    operations. Returns (t (N,), idx (N,) int32, hit (N,) bool)."""
    n = org.shape[0]
    o0, o1, o2 = org[:, 0], org[:, 1], org[:, 2]
    d0, d1, d2 = d[:, 0], d[:, 1], d[:, 2]
    best_t = torch.full_like(d0, BIG)
    best_idx = torch.zeros(n, dtype=torch.int32, device=org.device)
    for s in range(table.shape[1]):
        ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = table[:, s]
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
              & (vv >= 0.0) & (uu + vv <= 1.0) & (tt >= 0.0))
        cand = torch.where(ok, tt, BIG)
        upd = cand < best_t
        best_t = torch.where(upd, cand, best_t)
        best_idx = torch.where(upd, s, best_idx).to(torch.int32)
    live = alive.reshape(-1, RAY_BLOCK).any(dim=1)
    live = live.repeat_interleave(RAY_BLOCK)
    best_t = torch.where(live, best_t, BIG)
    best_idx = torch.where(live, best_idx, 0).to(torch.int32)
    return best_t, best_idx, best_t < BIG


def tri_pair_stages(table, org, d):
    """Per ray and column, where csrc/intersect_tris.cu leaves the pair, in
    its float32 operations: (stage, accepted), (N, T) int8 and bool. stage
    is PAD (a column whose six edge components are all +-0), AT_DET,
    AT_U or AT_VT (the pre-reject's three exits, in the kernel's order) or
    FULL (the pair runs the full test); accepted is the full test's result
    (the JAX kernel's `ok`)."""
    f = lambda x: x.to(torch.float32)[:, None]
    o0, o1, o2 = f(org[:, 0]), f(org[:, 1]), f(org[:, 2])
    d0, d1, d2 = f(d[:, 0]), f(d[:, 1]), f(d[:, 2])
    ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = table[:, None, :]
    pad = ((e1x == 0) & (e1y == 0) & (e1z == 0) & (e2x == 0) & (e2y == 0)
           & (e2z == 0))
    pvx = d1 * e2z - d2 * e2y
    pvy = d2 * e2x - d0 * e2z
    pvz = d0 * e2y - d1 * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    tvx, tvy, tvz = o0 - ax, o1 - ay, o2 - az
    u_n = tvx * pvx + tvy * pvy + tvz * pvz
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v_n = d0 * qvx + d1 * qvy + d2 * qvz
    t_n = e2x * qvx + e2y * qvy + e2z * qvz
    # the pre-reject
    ad = torch.abs(det)
    neg = det < 0
    su, sv, st = (torch.where(neg, -x, x) for x in (u_n, v_n, t_n))
    regular = ad <= _REGULAR
    at_u = regular & ((su < -_TINY) | (su > ad * _M1))
    at_vt = regular & ((sv < -_TINY) | (st < -_TINY) | (su + sv > ad * _M2))
    stage = torch.full(pad.shape, FULL, dtype=torch.int8, device=pad.device)
    for mask, at in ((at_vt, AT_VT), (at_u, AT_U), (~(ad >= _EPS), AT_DET),
                     (pad, PAD)):
        stage = torch.where(mask, at, stage).to(torch.int8)
    # the full test
    det_inv = 1.0 / det
    uu, vv, tt = det_inv * u_n, det_inv * v_n, det_inv * t_n
    accepted = ((ad >= _EPS) & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0)
                & (uu + vv <= 1.0) & (tt >= 0.0))
    return stage, accepted


def tri_pair_tests(table, org, d):
    """Per ray and column, (skipped, accepted), both (N, T) bool: skipped,
    the kernel never runs the full test (tri_pair_stages below FULL);
    accepted, the full test (the JAX kernel's `ok`). The kernel is right
    only if no pair is both."""
    stage, accepted = tri_pair_stages(table, org, d)
    return stage != FULL, accepted


def intersect_tris(table, org, d, alive):
    """Nearest hit of N rays against the (9, T) triangle table (the JAX
    intersect_tris_pallas). org, d: (N, 3) f32, N a multiple of 1024;
    alive: (N,) bool, for the per-block early exit. Returns
    (t (N,), idx (N,) int32, hit (N,) bool).

    CPU tensors run intersect_tris_plain; CUDA tensors launch
    csrc/intersect_tris.cu (counted in `intersect_tris.launches`); anything
    else raises."""
    if org.device.type == "cpu":
        return intersect_tris_plain(table, org, d, alive)
    if org.device.type != "cuda":
        raise ValueError(f"intersect_tris: no kernel for {org.device}")
    check_rays("intersect_tris", org, d, alive)
    n_t = table.shape[1] if table.dim() == 2 else 0
    if not (table.dim() == 2 and table.shape[0] == 9 and 0 < n_t <= 1024
            and table.dtype == torch.float32 and table.is_contiguous()
            and table.device == org.device):
        raise ValueError("intersect_tris: want a contiguous f32 (9, T) "
                         f"table, 0 < T <= 1024, on {org.device}; got "
                         f"{tuple(table.shape)} {table.dtype} {table.device}")
    n = org.shape[0]
    lib = _build.load()
    t = torch.empty(n, dtype=torch.float32, device=org.device)
    idx = torch.empty(n, dtype=torch.int32, device=org.device)
    err = lib.pt_intersect_tris(
        table.data_ptr(), n_t, org.data_ptr(), d.data_ptr(), alive.data_ptr(),
        t.data_ptr(), idx.data_ptr(), n,
        torch.cuda.current_stream(org.device).cuda_stream)
    _build.check(lib, err, "intersect_tris")
    intersect_tris.launches += 1
    return t, idx, t < BIG


intersect_tris.launches = 0
