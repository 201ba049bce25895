"""A closed triangle mesh for small tests: the icosahedron, each face cut
into four `level` times, its vertices pushed onto the sphere of `radius`
about `center`. Every edge is shared by two faces, which wind outwards.
Imports numpy only."""

import numpy as np

_T = (1.0 + 5.0 ** 0.5) / 2.0
_VERTS = [(-1, _T, 0), (1, _T, 0), (-1, -_T, 0), (1, -_T, 0), (0, -1, _T),
          (0, 1, _T), (0, -1, -_T), (0, 1, -_T), (_T, 0, -1), (_T, 0, 1),
          (-_T, 0, -1), (-_T, 0, 1)]
_FACES = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
          (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
          (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5),
          (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]


def icosphere(level: int, center, radius: float):
    """(vertices (V, 3) float32, faces (20 4^level, 3) int64)."""
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in _VERTS]
    faces = list(_FACES)
    for _ in range(level):
        mids = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                p = verts[a] + verts[b]
                verts.append(p / np.linalg.norm(p))
                mids[key] = len(verts) - 1
            return mids[key]

        cut = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            cut += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = cut
    out = np.asarray(verts) * radius + np.asarray(center, np.float64)
    return out.astype(np.float32), np.asarray(faces, np.int64)
