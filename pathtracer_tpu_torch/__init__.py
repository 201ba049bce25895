"""pathtracer_tpu_torch — the shirley-spheres path tracer in PyTorch, with its
two hot kernels hand-written in CUDA C++ for Hopper (sm_90a).

A port of the JAX package `pathtracer_tpu`, which stays the reference: module
names and layout mirror it, and the tests hold every module of this package
against its JAX counterpart on the same inputs.

Idiom:
- plain functions on tensors, with an explicit `device` argument wherever a
  tensor is created (no implicit CUDA or CPU default inside library code);
- `integrator.Renderer` is a `torch.nn.Module` holding the scene tables as
  buffers, so `.to(device)` moves them;
- no autograd (the path tracer has no gradient);
- randomness is the deterministic Roberts low-discrepancy sequence
  (`ops/lds.py`), a pure function of (offset, dimension): no
  `torch.Generator` is needed anywhere.

The kernels (`csrc/*.cu`) are compiled by `_build.py` with nvcc on first use.
Each kernel wrapper launches its kernel for CUDA tensors and runs the kernel's
plain PyTorch version only for CPU tensors.

This package imports neither `jax` nor `pathtracer_tpu`.
"""

__version__ = "0.1.0"
