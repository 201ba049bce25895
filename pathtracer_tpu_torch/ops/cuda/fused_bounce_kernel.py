"""One whole path-tracer bounce: nearest sphere, then shading.

Port of pathtracer_tpu/ops/pallas/fused_bounce_kernel.py:fused_bounce_pallas.
`fused_bounce` launches the CUDA kernel csrc/fused_bounce.cu for CUDA tensors;
`fused_bounce_plain` is the same function in plain PyTorch: the plain
versions of the two-kernel bounce, sphere_kernel.intersect_state_plain and
then shade_kernel.shade_state_plain. `fused_bounce` runs it for CPU tensors,
and the tests and chip_smoke.py hold the kernel against it.

Layout (the JAX kernel's): state (10, rows, 128) f32 planes [org3, dir3,
attn3, alive]; off (rows, 128) int32 LDS offsets (uint32 bit patterns); rad
(3, rows, 128) f32 radiance accumulator; rows a multiple of 8, so the flat
ray index i belongs to 1024-ray block i // 1024. block_lists = (lists
(n_blk, K) int32, counts (n_blk, 1) int32) gives each block its ascending
frustum-culled sphere list (bounce 0 in tile-major ray order); without
them the kernel walks sphere_bvh, the per-scene hierarchy of
sphere_kernel.build_sphere_bvh, which it then needs (the plain version
does not read it).
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _build
from . import check_tensors
from .shade_kernel import PK_PLANES, shade_state_plain
from .sphere_kernel import (LANES, RAY_BLOCK, check_state,
                            intersect_state_plain, tree_args)

__all__ = ["fused_bounce", "fused_bounce_plain"]


def fused_bounce_plain(sph_table, state, pack_table, off, limbs, bg, rad, *,
                       bg_mode: int, origin_zero: bool, block_lists=None,
                       sphere_bvh=None):
    """Plain PyTorch version of the fused bounce. Returns (state, rad)."""
    at, idx = intersect_state_plain(sph_table, state, origin_zero=origin_zero,
                                    block_lists=block_lists)
    return shade_state_plain(state, pack_table, idx, off, at, limbs, bg, rad,
                             bg_mode=bg_mode)


def fused_bounce(sph_table, state, pack_table, off, limbs, bg, rad, *,
                 bg_mode: int, origin_zero: bool, block_lists=None,
                 sphere_bvh=None):
    """One bounce over the wavefront; returns new (state, rad) tensors.

    CPU tensors run fused_bounce_plain; CUDA tensors launch the kernel (and
    count the launch in `fused_bounce.launches`); anything else raises."""
    if state.device.type == "cpu":
        return fused_bounce_plain(sph_table, state, pack_table, off, limbs,
                                  bg, rad, bg_mode=bg_mode,
                                  origin_zero=origin_zero,
                                  block_lists=block_lists)
    rows = check_state("fused_bounce", state)
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
    check_tensors("fused_bounce", state.device, checks)
    if pack_table.shape[1] * LANES < n_spheres:
        raise ValueError("fused_bounce: pack_table holds fewer entries than "
                         "sph_table")
    tree = tree_args("fused_bounce", sphere_bvh, state.device, n_spheres,
                     lists is not None)
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
        ptr(counts), 0 if lists is None else lists.shape[1], *tree,
        int(limbs[0, 0]), int(limbs[0, 1]), int(limbs[1, 0]),
        int(limbs[1, 1]), w0, w1, w2, s0, s1, s2, n, int(bg_mode),
        int(bool(origin_zero)),
        torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(lib, err, "fused_bounce")
    fused_bounce.launches += 1
    return state_out, rad_out


fused_bounce.launches = 0
