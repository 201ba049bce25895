"""The port's CUDA kernels: one module per kernel family, each with the
wrapper that launches the kernel for CUDA tensors, the plain PyTorch version
that it runs for CPU tensors, and a `launches` count on the wrapper. The
exception is mesh_bounce_kernel, whose plain version is the eager code of
integrator.trace_plain, which trace runs for CPU tensors."""

from __future__ import annotations

import sys


def check_tensors(what: str, device, checks) -> None:
    """Raise ValueError unless every (name, tensor, dtype, shape) of
    `checks` lies on `device`, has that dtype and shape, and is contiguous:
    the argument contract of a kernel launch."""
    for name, t, dtype, shape in checks:
        problem = (f"{name} on {t.device}, want {device}"
                   if t.device != device else
                   f"{name} dtype {t.dtype}, want {dtype}"
                   if t.dtype != dtype else
                   f"{name} shape {tuple(t.shape)}, want {tuple(shape)}"
                   if tuple(t.shape) != tuple(shape) else
                   f"{name} is not contiguous"
                   if not t.is_contiguous() else None)
        if problem:
            raise ValueError(f"{what}: {problem}")


def kernel_wrappers() -> set:
    """Every kernel wrapper of this package: a function with a `launches`
    count (what a CUDA graph's replay adds again), in the kernel modules
    that the process has loaded. mesh_bounce_kernel loads only where the
    mesh path tracer first runs on a card, and a module never loaded has
    launched nothing."""
    from . import (bvh_walk_kernel, compact_kernel, fused_bounce_kernel,
                   gather_kernel, shade_kernel, sphere_kernel,
                   tile_tri_kernel, tri_kernel)
    modules = [bvh_walk_kernel, compact_kernel, fused_bounce_kernel,
               gather_kernel, shade_kernel, sphere_kernel, tile_tri_kernel,
               tri_kernel]
    lazy = sys.modules.get(__name__ + ".mesh_bounce_kernel")
    if lazy is not None:
        modules.append(lazy)
    return {f for m in modules for f in vars(m).values()
            if callable(f) and hasattr(f, "launches")}
