"""Per-ray triangle math of the composite intersector.

Port of pathtracer_tpu/ops/triangles.py:mt_single. The nearest-triangle
search itself is ops/cuda/tri_kernel.py:intersect_tris.
"""

from __future__ import annotations

from . import vec

__all__ = ["mt_single"]


def mt_single(a, e1, e2, org, d):
    """Moller-Trumbore of each ray against its own (gathered) triangle.
    a, e1, e2, org, d: (N, 3). Returns (t, u, v), each (N,); used to
    recompute the winner's barycentrics for shading."""
    pvec = vec.cross(d, e2)
    det = vec.dot(e1, pvec)
    det_inv = 1.0 / det
    tvec = org - a
    u = det_inv * vec.dot(tvec, pvec)
    qvec = vec.cross(tvec, e1)
    v = det_inv * vec.dot(d, qvec)
    t = det_inv * vec.dot(e2, qvec)
    return t, u, v
