"""Per-ray sphere math of the composite intersector.

Port of pathtracer_tpu/ops/spheres.py:stable_t. The nearest-sphere search
itself is ops/cuda/sphere_kernel.py:intersect_spheres.
"""

from __future__ import annotations

import torch

from . import vec

__all__ = ["stable_t"]


def stable_t(center_h, r2_h, org, d, a, inv_a) -> torch.Tensor:
    """Reference-stable t for each ray's selected sphere from its gathered
    center (N, 3) and r^2 (N,): c/q outside the sphere, q/a inside."""
    f = center_h - org
    bp = vec.dot(f, d)
    quad_f = vec.quadrance(f)
    c = quad_f - r2_h
    discrim = r2_h - quad_f + bp * bp * inv_a
    sign_bp = torch.where(bp >= 0.0, 1.0, -1.0).to(bp.dtype)
    q = sign_bp * vec.sqrt(torch.clamp(a * discrim, min=0.0)) + bp
    return torch.where(c > 0.0, c / q, q * inv_a)
