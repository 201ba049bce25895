"""One whole path-tracer bounce: nearest sphere, then shading.

Port of pathtracer_tpu/ops/pallas/fused_bounce_kernel.py:fused_bounce_pallas.
`fused_bounce` launches the CUDA kernel csrc/fused_bounce.cu for CUDA tensors;
`fused_bounce_plain` is the same function in plain PyTorch (sphere_kernel's
intersection, then shade_kernel.shade), which `fused_bounce` runs for CPU
tensors and which the tests and chip_smoke.py hold the kernel against.

Layout (the JAX kernel's): state (10, rows, 128) f32 planes [org3, dir3,
attn3, alive]; off (rows, 128) int32 LDS offsets (uint32 bit patterns); rad
(3, rows, 128) f32 radiance accumulator; rows a multiple of 8, so the flat
ray index i belongs to 1024-ray block i // 1024. block_lists = (lists
(n_blk, K) int32, counts (n_blk, 1) int32) gives each block its ascending
frustum-culled sphere list (bounce 0 in tile-major ray order).
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _build
from .shade_kernel import PK_PLANES, shade
from .sphere_kernel import (BIG, LANES, RAY_BLOCK, intersect_regs,
                            intersect_regs_listed)

__all__ = ["fused_bounce", "fused_bounce_plain"]


def fused_bounce_plain(sph_table, state, pack_table, off, limbs, bg, rad, *,
                       bg_mode: int, origin_zero: bool, block_lists=None):
    """Plain PyTorch version of the fused bounce. Returns (state, rad)."""
    comps = [state[c].reshape(-1) for c in range(6)]
    if block_lists is None:
        best_at, best_idx = intersect_regs(sph_table, *comps,
                                           origin_zero=origin_zero)
    else:
        lists, counts = block_lists
        best_at, best_idx = intersect_regs_listed(
            sph_table, lists, counts, *comps, origin_zero=origin_zero)
    shape = state.shape[1:]
    hit = (best_at.reshape(shape) < BIG) & (state[9] > 0.0)
    return shade(pack_table, state, off, best_idx.reshape(shape), hit, limbs,
                 bg, rad, bg_mode)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"fused_bounce: {what}")


def fused_bounce(sph_table, state, pack_table, off, limbs, bg, rad, *,
                 bg_mode: int, origin_zero: bool, block_lists=None):
    """One bounce over the wavefront; returns new (state, rad) tensors.

    CPU tensors run fused_bounce_plain; CUDA tensors launch the kernel (and
    count the launch in `fused_bounce.launches`); anything else raises."""
    if state.device.type == "cpu":
        return fused_bounce_plain(sph_table, state, pack_table, off, limbs,
                                  bg, rad, bg_mode=bg_mode,
                                  origin_zero=origin_zero,
                                  block_lists=block_lists)
    _require(state.device.type == "cuda",
             f"no kernel for device {state.device}")
    _require(state.dim() == 3 and state.shape[0] == 10
             and state.shape[2] == LANES and state.shape[1] % 8 == 0,
             f"state must be (10, 8k, {LANES}), got {tuple(state.shape)}")
    rows = state.shape[1]
    n = rows * LANES
    n_spheres = sph_table.shape[1] if sph_table.dim() == 2 else -1
    checks = [("sph_table", sph_table, torch.float32, (4, n_spheres)),
              ("state", state, torch.float32, (10, rows, LANES)),
              ("pack_table", pack_table, torch.float32,
               (PK_PLANES, pack_table.shape[1], LANES)),
              ("off", off, torch.int32, (rows, LANES)),
              ("rad", rad, torch.float32, (3, rows, LANES))]
    lists = counts = None
    if block_lists is not None:
        lists, counts = block_lists
        n_blk = n // RAY_BLOCK
        checks += [("lists", lists, torch.int32, (n_blk, lists.shape[1])),
                   ("counts", counts, torch.int32, (n_blk, 1))]
    for name, t, dtype, shape in checks:
        _require(t.device == state.device, f"{name} on {t.device}, "
                 f"state on {state.device}")
        _require(t.dtype == dtype, f"{name} dtype {t.dtype}, want {dtype}")
        _require(tuple(t.shape) == tuple(shape),
                 f"{name} shape {tuple(t.shape)}, want {tuple(shape)}")
        _require(t.is_contiguous(), f"{name} is not contiguous")
    _require(pack_table.shape[1] * LANES >= n_spheres,
             "pack_table holds fewer entries than sph_table")
    limbs = np.asarray(limbs, np.uint32)
    (w0, w1, w2), (s0, s1, s2) = bg

    lib = _build.load()
    state_out = torch.empty_like(state)
    rad_out = torch.empty_like(rad)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.pt_fused_bounce(
        sph_table.data_ptr(), n_spheres, pack_table.data_ptr(),
        pack_table.shape[1] * LANES, state.data_ptr(), state_out.data_ptr(),
        off.data_ptr(), rad.data_ptr(), rad_out.data_ptr(), ptr(lists),
        ptr(counts), 0 if lists is None else lists.shape[1],
        int(limbs[0, 0]), int(limbs[0, 1]), int(limbs[1, 0]),
        int(limbs[1, 1]), w0, w1, w2, s0, s1, s2, n, int(bg_mode),
        int(bool(origin_zero)),
        torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(lib, err, "fused_bounce")
    fused_bounce.launches += 1
    return state_out, rad_out


fused_bounce.launches = 0
