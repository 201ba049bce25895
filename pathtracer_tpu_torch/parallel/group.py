"""Process groups and the collectives of multi-device rendering.

One process per device. `init` joins this process to the group: NCCL for
a CUDA device (cuda:LOCAL_RANK), gloo for the CPU, and gloo on a CUDA
device only where the caller asks for it (two ranks on one card: NCCL
refuses two ranks on the same GPU). Rank, world size and local rank come
from the environment that `torchrun` sets (RANK, WORLD_SIZE, LOCAL_RANK,
with an env:// rendezvous), or from the caller with a file:// rendezvous
(`spawn`). Asking for CUDA without a card raises, and so does a failed
NCCL init: no rank carries on on the CPU.

The collectives take their group explicitly (a ProcessGroup, e.g. a
DeviceMesh dimension's):
  - all_reduce_sum, in place;
  - all_gather_rows, the concatenation along dim 0 of every rank's tensor
    in rank order, whose row counts may differ per rank (the counts are
    gathered first and the rows padded to the longest);
  - ring_shift, every rank's tensors to rank (r+1) % n, from (r-1) % n,
    in one dist.batch_isend_irecv; every rank sends the same shapes.
Under gloo, ring_shift takes CUDA tensors through host memory, decided
from the backend before the call (NCCL never stages): gloo's
point-to-point ops write raw buffers to TCP and abort on a device
pointer, while its all_reduce and all_gather take CUDA tensors (both
seen on an H100 with torch 2.11).

spawn runs a rank entry point on new processes, for the tests and
chip_smoke.py; a rank whose entry point's module imports JAX raises.
"""

from __future__ import annotations

import datetime
import importlib
import os
import sys
import tempfile

import torch
import torch.distributed as dist

__all__ = ["init", "all_reduce_sum", "all_gather_rows", "ring_shift",
           "spawn"]

# how long a rank waits in a collective for the others before it raises
TIMEOUT = datetime.timedelta(seconds=600)


def init(device, backend: str | None = None, init_method: str | None = None,
         rank: int | None = None, world_size: int | None = None,
         local_rank: int | None = None) -> torch.device:
    """Join this process to the default process group and return its
    device. device "cuda" (cuda:local_rank, NCCL unless backend="gloo") or
    "cpu" (gloo). rank, world_size and local_rank default to the RANK,
    WORLD_SIZE and LOCAL_RANK variables; init_method to env:// (torchrun's
    MASTER_ADDR and MASTER_PORT). One all_reduce at the end makes NCCL
    build its communicator here, so a failed NCCL init raises here."""
    device = torch.device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("parallel.init: CUDA asked for and no CUDA "
                               "device is present")
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", 0))
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"parallel.init: local rank {local_rank} "
                               f"with {torch.cuda.device_count()} card(s)")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        backend = backend or "nccl"
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"parallel.init: backend {backend!r} on CUDA")
    elif device.type == "cpu":
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"parallel.init: the CPU takes gloo, not "
                             f"{backend!r}")
    else:
        raise ValueError(f"parallel.init: no backend for {device}")
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size, timeout=TIMEOUT,
        device_id=device if backend == "nccl" else None)
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    if int(probe.item()) != world_size:
        raise RuntimeError(f"parallel.init: all_reduce of ones gave "
                           f"{probe.item()} on {world_size} ranks")
    return device


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum t over the group, in place; returns t."""
    dist.all_reduce(t, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's t concatenated along dim 0 in rank order, on t's
    device; the row counts may differ per rank, the other dims may not.
    Bool tensors travel as uint8."""
    if t.dtype == torch.bool:
        return all_gather_rows(t.to(torch.uint8), group).bool()
    n = dist.get_world_size(group)
    x = t.contiguous()
    rows = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    sizes = [torch.empty_like(rows) for _ in range(n)]
    dist.all_gather(sizes, rows, group=group)
    sizes = [int(s) for s in sizes]
    longest = max(sizes)
    if x.shape[0] < longest:
        x = torch.cat([x, x.new_zeros((longest - x.shape[0],)
                                      + tuple(x.shape[1:]))])
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])


def ring_shift(tensors, group) -> list:
    """Send each tensor to rank (r+1) % n of the group and receive the
    tensors of rank (r-1) % n, of the same shapes and dtypes, in one
    batch; returns the received tensors on the inputs' devices."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    host = dist.get_backend(group) == "gloo"
    ops, recvs = [], []
    for t in tensors:
        send = t.cpu() if host else t.contiguous()
        recv = torch.empty_like(send)
        ops += [dist.P2POp(dist.isend, send, nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)]
        recvs.append(recv)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [x.to(t.device) for x, t in zip(recvs, tensors)]


def _entry(fn_name: str):
    module, _, name = fn_name.partition(":")
    if not module or not name:
        raise ValueError(f"spawn: want '<module>:<function>', got "
                         f"{fn_name!r}")
    return getattr(importlib.import_module(module), name)


def _rank_main(rank: int, fn_name: str, world: int, device: str,
               backend: str | None, rdv: str, spec) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
        local = None
    else:
        local = rank % max(torch.cuda.device_count(), 1)
    fn = _entry(fn_name)
    if "jax" in sys.modules:
        raise RuntimeError(f"spawn: {fn_name} imports jax in the rank; an "
                           f"entry point imports the port only")
    dev = init(device, backend, init_method=f"file://{rdv}/rendezvous",
               rank=rank, world_size=world, local_rank=local)
    try:
        out = fn(dev, spec)
        if rank == 0:
            torch.save(out, os.path.join(rdv, "result.tmp"))
            os.replace(os.path.join(rdv, "result.tmp"),
                       os.path.join(rdv, "result.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn_name: str, world: int, device: str, backend: str | None,
          rdv_dir: str, spec):
    """Run fn(device, spec) on `world` new processes, one per rank, joined
    to one group by a file:// rendezvous in a new directory under rdv_dir,
    and return rank 0's result (tensors, numbers, strings, lists and dicts
    of them). fn_name is '<module>:<function>', importable from this
    process's sys.path; a child raises if that import brings in JAX (a
    function of a test module would). device "cpu" runs gloo ranks of one
    thread each; "cuda" runs rank r on card r % (cards), with NCCL unless
    backend is "gloo". Waits for every rank; a rank that raises makes spawn
    raise."""
    _entry(fn_name)  # the name resolves here before any process starts
    os.makedirs(rdv_dir, exist_ok=True)
    rdv = tempfile.mkdtemp(prefix="rdv_", dir=rdv_dir)
    torch.multiprocessing.spawn(
        _rank_main, args=(fn_name, world, device, backend, rdv, spec),
        nprocs=world, join=True)
    return torch.load(os.path.join(rdv, "result.pt"), weights_only=True)
