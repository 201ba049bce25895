"""3-vector algebra over tensors with trailing dim 3.

Port of pathtracer_tpu/ops/vec.py. Sums over the three components are
written out left to right, so they round alike on every device. `normalize`
scales by 1/|a| rounded once from float64, as camera.ray_dirs does: XLA's
rsqrt is within an ulp of that, and torch.rsqrt on CUDA is approximate.
`sqrt` is the correctly rounded square root of XLA and of CUDA's sqrtf on
every device.
"""

from __future__ import annotations

import torch

__all__ = ["v3", "dot", "quadrance", "norm", "normalize", "sqrt", "inv_sqrt",
           "cross", "scale", "lerp", "where3"]


def v3(x, y, z) -> torch.Tensor:
    """Stack three same-shaped tensors into a trailing-dim-3 tensor."""
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def dot(a, b) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def quadrance(a) -> torch.Tensor:
    return dot(a, a)


def norm(a) -> torch.Tensor:
    return sqrt(quadrance(a))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt. torch's float32 sqrt of a large CPU tensor
    goes through MKL, which is not correctly rounded; on the CPU it is
    taken in float64 and rounded once."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.to(torch.float64)).to(x.dtype)
    return torch.sqrt(x)


def inv_sqrt(x: torch.Tensor) -> torch.Tensor:
    """1/sqrt(x) rounded once from float64 (the port's rsqrt)."""
    return (1.0 / torch.sqrt(x.to(torch.float64))).to(x.dtype)


def normalize(a) -> torch.Tensor:
    return a * inv_sqrt(quadrance(a))[..., None]


def cross(a, b) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return v3(ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def scale(a, s) -> torch.Tensor:
    return a * torch.as_tensor(s, dtype=a.dtype, device=a.device)[..., None]


def lerp(t, a, b) -> torch.Tensor:
    """(1-t)*a + t*b with a scalar or batched t."""
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)[..., None]
    return a * (1.0 - t) + b * t


def where3(mask, a, b) -> torch.Tensor:
    """Select whole vectors by a (...,)-shaped boolean mask."""
    return torch.where(mask[..., None], a, b)
