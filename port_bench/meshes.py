"""The mesh input of the ganesha cells: the committed PLY, turned about its
vertical axis by an angle drawn from the seed.

The benchmark reads the committed file (binary little-endian: float x, y,
z vertices, then uchar-counted int triangle lists), turns the vertices
about the world y axis through the centre of their box (the yaw of seed 0
is 0), rounds them to float32 and writes them in the same layout to a
fixed file name under the temporary directory. The program builds its
scene from that file through its own loader; the reference takes the same
float32 vertices and the faces.
"""

from __future__ import annotations

import math
import os
import tempfile

import numpy as np

__all__ = ["read_ply", "write_ply", "yaw_angle", "yawed", "temp_path"]

_GOLDEN = 0x9E3779B97F4A7C15  # 2^64 / golden ratio


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(vertices (V, 3) float32, faces (F, 3) int64) of a triangle PLY in
    the committed layout; any other layout raises."""
    with open(path, "rb") as f:
        buf = f.read()
    end = buf.index(b"end_header\n") + len(b"end_header\n")
    head = buf[:end].decode("ascii").split("\n")
    counts = {}
    for line in head:
        parts = line.split()
        if parts[:1] == ["element"]:
            counts[parts[1]] = int(parts[2])
    expected = ["ply", "format binary_little_endian 1.0",
                f"element vertex {counts.get('vertex')}", "property float x",
                "property float y", "property float z",
                f"element vertex_indices {counts.get('vertex_indices')}",
                "property list uchar int vertex_indices", "end_header", ""]
    if head != expected:
        raise ValueError(f"{path}: not a float xyz / uchar-int triangle PLY")
    nv, nf = counts["vertex"], counts["vertex_indices"]
    verts = np.frombuffer(buf, "<f4", 3 * nv, end).reshape(nv, 3)
    rows = np.frombuffer(buf, np.uint8, 13 * nf, end + 12 * nv)
    rows = rows.reshape(nf, 13)
    if (rows[:, 0] != 3).any():
        raise ValueError(f"{path}: a face is not a triangle")
    faces = rows[:, 1:].copy().view("<i4").reshape(nf, 3)
    return verts.astype(np.float32), faces.astype(np.int64)


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    nv, nf = len(verts), len(faces)
    head = (f"ply\nformat binary_little_endian 1.0\nelement vertex {nv}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element vertex_indices {nf}\n"
            "property list uchar int vertex_indices\nend_header\n")
    rows = np.empty((nf, 13), np.uint8)
    rows[:, 0] = 3
    rows[:, 1:] = np.ascontiguousarray(faces, "<i4").view(np.uint8)
    with open(path, "wb") as f:
        f.write(head.encode("ascii"))
        f.write(np.ascontiguousarray(verts, "<f4").tobytes())
        f.write(rows.tobytes())


def yaw_angle(seed: int) -> float:
    """2 pi frac(seed / golden ratio): 0 for seed 0, spread over the turn."""
    return 2.0 * math.pi * (((seed * _GOLDEN) & ((1 << 64) - 1)) / 2.0 ** 64)


def yawed(verts: np.ndarray, seed: int) -> np.ndarray:
    """The vertices turned by yaw_angle(seed) about the y axis through the
    centre of their box, rounded to float32."""
    v = verts.astype(np.float64)
    mid = 0.5 * (v.min(0) + v.max(0))
    a = yaw_angle(seed)
    c, s = math.cos(a), math.sin(a)
    x, z = v[:, 0] - mid[0], v[:, 2] - mid[2]
    out = v.copy()
    out[:, 0] = mid[0] + c * x + s * z
    out[:, 2] = mid[2] - s * x + c * z
    return out.astype(np.float32)


def temp_path(name: str) -> str:
    """A fixed file name under the temporary directory (TMPDIR)."""
    d = os.path.join(tempfile.gettempdir(), "port_bench")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name)
