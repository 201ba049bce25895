"""Pinhole camera with scene-to-camera-space pre-transform.

Port of pathtracer_tpu/camera.py: `Camera.create` is the same host float64
code; `ray_dirs` is float32 torch. All scene geometry is transformed into
camera space at build time, so primary rays start at the origin and ray
generation is dir = normalize(lower_left + view * (cx, cy), -1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Camera:
    look_at: np.ndarray  # (3, 4) float64 world->camera affine transform
    lower_left_x: float
    lower_left_y: float
    view_x: float
    view_y: float

    @staticmethod
    def create(eye, target, up, aspect: float, vertical_fov_deg: float) -> "Camera":
        eye = np.asarray(eye, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)

        def _norm(v):
            return v / math.hypot(v[0], math.hypot(v[1], v[2]))

        zp = _norm(target - eye)
        xp = _norm(np.cross(zp, _norm(up)))
        yp = _norm(np.cross(xp, zp))
        m = np.empty((3, 4), np.float64)
        m[0, :3] = xp
        m[0, 3] = -float(eye @ xp)
        m[1, :3] = yp
        m[1, 3] = -float(eye @ yp)
        m[2, :3] = -zp
        m[2, 3] = float(eye @ zp)

        half_h = math.tan(0.5 * math.radians(vertical_fov_deg))
        half_w = aspect * half_h
        return Camera(
            look_at=m,
            lower_left_x=-half_w,
            lower_left_y=-half_h,
            view_x=2.0 * half_w,
            view_y=2.0 * half_h,
        )

    def transform_points(self, pts: np.ndarray) -> np.ndarray:
        """Host-side (float64) world->camera transform of (N, 3) points."""
        pts = np.asarray(pts, np.float64)
        return pts @ self.look_at[:, :3].T + self.look_at[:, 3]

    def ray_dirs(self, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
        """Unit primary ray directions (..., 3) float32 from film coords in
        [0,1]^2 (float32 tensors on any device); origins are the camera-space
        origin."""
        f32 = lambda x: float(np.float32(x))
        d0 = f32(self.lower_left_x) + f32(self.view_x) * cx
        d1 = f32(self.lower_left_y) + f32(self.view_y) * cy
        d2 = torch.full_like(cx, -1.0)
        # 1/|d| rounded once from float64: within 1 ulp of XLA's rsqrt on
        # both devices (torch.rsqrt is approximate on CUDA)
        q = (d0 * d0 + d1 * d1 + d2 * d2).to(torch.float64)
        inv = (1.0 / torch.sqrt(q)).to(torch.float32)
        return torch.stack([d0 * inv, d1 * inv, d2 * inv], dim=-1)
