"""Wavefront lane compaction: a stable partition of each 1024-lane block.

Port of pathtracer_tpu/ops/pallas/compact_kernel.py. `compact_blocks`
launches the CUDA kernel csrc/compact.cu for CUDA tensors;
`compact_blocks_plain` is the same function in plain PyTorch (the argsort
partition of the JAX compact_blocks_ref), which `compact_blocks` runs for CPU
tensors. The two are bit-identical. `pack_rows` and `dest_map` are the torch
glue around it, as the JAX package runs them in XLA.

Live lanes (state[9] > 0) move to the front of their block in order with
their 9 payload planes and LDS offset; the tail is zeroed and the alive plane
rebuilt. Radiance does not travel: the caller flushes it home first.
"""

from __future__ import annotations

import torch

from ... import _build
from .sphere_kernel import LANES, RAY_BLOCK

__all__ = ["compact_blocks", "compact_blocks_plain", "pack_rows", "dest_map"]

BLOCK_ROWS = RAY_BLOCK // LANES  # 8
N_STATE = 10  # org3, dir3, attn3, alive


def compact_blocks_plain(state, off):
    """state (10, rows, 128) f32, off (rows, 128) int32 -> (state_c, off_c,
    k (rows / 8,) int32 live counts per block)."""
    _, rows, lanes = state.shape
    nblk = rows // BLOCK_ROWS
    alive = (state[9] > 0.0).reshape(nblk, RAY_BLOCK)
    order = torch.argsort((~alive).to(torch.uint8), dim=1, stable=True)
    k = alive.sum(dim=1).to(torch.int32)
    live = (torch.arange(RAY_BLOCK, device=state.device)[None, :]
            < k[:, None])

    def pack(x):
        xc = torch.gather(x.reshape(nblk, RAY_BLOCK), 1, order)
        return torch.where(live, xc, torch.zeros_like(xc)).reshape(rows,
                                                                   lanes)

    st_c = torch.stack([pack(state[c]) for c in range(N_STATE - 1)]
                       + [live.to(torch.float32).reshape(rows, lanes)])
    return st_c, pack(off), k


def compact_blocks(state, off):
    """Stable partition of each block. CPU tensors run compact_blocks_plain;
    CUDA tensors launch the kernel (counted in `compact_blocks.launches`);
    anything else raises."""
    if state.device.type == "cpu":
        return compact_blocks_plain(state, off)
    if state.device.type != "cuda":
        raise ValueError(f"compact_blocks: no kernel for device {state.device}")
    if not (state.dim() == 3 and state.shape[0] == N_STATE
            and state.shape[2] == LANES and state.shape[1] % BLOCK_ROWS == 0):
        raise ValueError(f"compact_blocks: state must be (10, 8k, {LANES}), "
                         f"got {tuple(state.shape)}")
    rows = state.shape[1]
    if not (state.dtype == torch.float32 and off.dtype == torch.int32
            and tuple(off.shape) == (rows, LANES)
            and off.device == state.device
            and state.is_contiguous() and off.is_contiguous()):
        raise ValueError("compact_blocks: want contiguous f32 state and "
                         f"int32 off of shape ({rows}, {LANES}) on "
                         f"{state.device}")
    nblk = rows // BLOCK_ROWS
    lib = _build.load()
    st_c = torch.empty_like(state)
    off_c = torch.empty_like(off)
    k = torch.empty(nblk, dtype=torch.int32, device=state.device)
    err = lib.pt_compact_blocks(
        state.data_ptr(), off.data_ptr(), st_c.data_ptr(), off_c.data_ptr(),
        k.data_ptr(), nblk,
        torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(lib, err, "compact_blocks")
    compact_blocks.launches += 1
    return st_c, off_c, k


compact_blocks.launches = 0


def pack_rows(state_c, off_c, k):
    """Pack the per-block compacted wavefront at row granularity: each
    block's ceil(k/128) used rows move to the front (stable), dead rows to
    the back. Returns (state_p, off_p, n_used_rows) with n_used_rows a
    0-dim tensor on the device."""
    rows = state_c.shape[1]
    u = (k + (LANES - 1)) // LANES  # used rows per block
    r = torch.arange(rows, device=state_c.device)
    used = (r % BLOCK_ROWS) < u[r // BLOCK_ROWS]
    perm = torch.argsort((~used).to(torch.uint8), stable=True)
    return state_c[:, perm], off_c[perm], u.sum()


def dest_map(alive_pre, k):
    """Closed-form forward map of compact_blocks + pack_rows: for each
    original flat lane i with alive_pre[i], dest[i] is its flat index in the
    packed order (garbage where dead: mask with alive_pre).

    alive_pre: (rows, 128) bool before compaction; k: (nblk,) live counts.
    Returns dest (rows * 128,) int32."""
    rows = alive_pre.shape[0]
    nblk = rows // BLOCK_ROWS
    u = (k + (LANES - 1)) // LANES
    out_base = torch.cumsum(u, 0) - u  # first packed row of each block
    a = alive_pre.reshape(nblk, RAY_BLOCK)
    dib = torch.cumsum(a.to(torch.int32), dim=1) - 1  # in-block dest
    out_row = out_base[:, None] + torch.div(dib, LANES, rounding_mode="floor")
    return (out_row * LANES + torch.remainder(dib, LANES)).reshape(-1).to(
        torch.int32)
