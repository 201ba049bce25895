"""Per-tile frustum cone planes for block-granularity culling (host, f64).

Copy of pathtracer_tpu/ops/frustum.py (tile_frustum_planes). Primary rays all
start at the camera-space origin, so a 32x32 image tile's rays lie inside the
cone hulled by its 4 corner directions; the bounce-0 sphere lists
(integrator.tile_sphere_lists) cull against these planes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["tile_frustum_planes"]


def tile_frustum_planes(camera, width: int, height: int, tx_n: int, ty_n: int,
                        *, flip_y: bool, tile: int = 32) -> np.ndarray:
    """(T, 4, 3) f64 inward-pointing unit plane normals per tile: the 4
    frustum side planes through the origin. (The JAX copy's with_z_plane
    option serves only the tile-culled triangle kernel, not ported yet.)

    flip_y must match the consumer's film map: the path tracer's is
    cy = 1 - y/H (flip_y=True).

    Corner pixel coords [x0, x0+tile] x [y0, y0+tile] cover every jittered
    sample (dx, dy in [0,1)) and the clamped coords of padded edge tiles.
    Corner dirs come from the camera's affine film map unnormalized —
    runtime normalization rescales rays positively and cannot change the
    cone.
    """
    xs = np.arange(tx_n + 1) * (tile / width)
    ys = np.arange(ty_n + 1) * (tile / height)
    cx = np.broadcast_to(xs[None, :], (ty_n + 1, tx_n + 1))
    cy = np.broadcast_to(ys[:, None], (ty_n + 1, tx_n + 1))
    if flip_y:
        cy = 1.0 - cy
    dirs = np.stack([camera.lower_left_x + camera.view_x * cx,
                     camera.lower_left_y + camera.view_y * cy,
                     np.full(cx.shape, -1.0)], axis=-1)  # (ty+1, tx+1, 3)
    c00 = dirs[:-1, :-1].reshape(-1, 3)
    c01 = dirs[:-1, 1:].reshape(-1, 3)
    c10 = dirs[1:, :-1].reshape(-1, 3)
    c11 = dirs[1:, 1:].reshape(-1, 3)
    center = c00 + c01 + c10 + c11  # interior direction for sign fixing
    planes = []
    for a, b in ((c00, c01), (c01, c11), (c11, c10), (c10, c00)):
        nrm = np.cross(a, b)
        nrm *= np.sign(np.sum(nrm * center, axis=1, keepdims=True))
        n_len = np.linalg.norm(nrm, axis=1, keepdims=True)
        planes.append(nrm / np.maximum(n_len, 1e-300))
    return np.stack(planes, axis=1)
