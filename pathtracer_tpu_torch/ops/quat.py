"""Batched unit-quaternion rotations, stored as (..., 4) tensors [w, x, y, z].

Port of pathtracer_tpu/ops/quat.py; `rotate` is the same two-cross-product
expansion of q (0, v) q*.
"""

from __future__ import annotations

import torch

from . import vec

__all__ = ["quat", "normalize", "mul", "conj", "rotate", "rotate_inv",
           "from_axis_angle"]


def quat(w, v) -> torch.Tensor:
    """Build a quaternion from a scalar part (...,) and a vector part
    (..., 3)."""
    return torch.cat([w[..., None], v], dim=-1)


def normalize(q) -> torch.Tensor:
    qq = q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1] \
        + q[..., 2] * q[..., 2] + q[..., 3] * q[..., 3]
    return q * vec.inv_sqrt(qq)[..., None]


def mul(a, b) -> torch.Tensor:
    """Hamilton product."""
    aw, av = a[..., 0], a[..., 1:]
    bw, bv = b[..., 0], b[..., 1:]
    w = aw * bw - vec.dot(av, bv)
    v = vec.cross(av, bv) + av * bw[..., None] + bv * aw[..., None]
    return quat(w, v)


def conj(q) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def rotate(q, v) -> torch.Tensor:
    """Rotate v by q: q (0, v) q*."""
    w, qv = q[..., 0], q[..., 1:]
    t = 2.0 * vec.cross(qv, v)
    return v + t * w[..., None] + vec.cross(qv, t)


def rotate_inv(q, v) -> torch.Tensor:
    """Rotate v by q* (the inverse rotation for unit q)."""
    return rotate(conj(q), v)


def from_axis_angle(axis, angle) -> torch.Tensor:
    """Unit quaternion rotating by `angle` about `axis`."""
    axis = vec.normalize(axis)
    half = angle * 0.5
    return normalize(quat(torch.cos(half), axis * torch.sin(half)[..., None]))
