"""Stanford PLY parser (binary little-endian), numpy-columnar.

Copy of pathtracer_tpu/io/ply.py (pure numpy; the port keeps its own copy
and imports nothing of the JAX package). Mirrors the reference
`ply_format` (`ply_format/src/ply.ml`): magic check
"ply\\n", header -> elements with atomic and list properties, then
binary-little-endian columnar decode; ASCII and big-endian formats error out
exactly like the reference (ply.ml:345-350). Fixed-width elements decode via
one strided numpy view per property; the reference's one-list-property
element (vertex_indices) decodes to a (count, k) int array when row lengths
are uniform (the mesh fast path) or a list of arrays otherwise.

Deviation from the reference (documented): ply.ml's int accessor reads
Short/Ushort with the *int8* getters (ply.ml:100-103) — a dormant bug for
typical assets (uchar lengths, int indices). We read shorts correctly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Union

import numpy as np

_DTYPES = {
    "char": np.int8, "int8": np.int8,
    "uchar": np.uint8, "uint8": np.uint8,
    "short": np.int16, "ushort": np.uint16,
    "int": np.int32, "uint": np.uint32,
    "float": np.float32, "double": np.float64,
}


class PlyError(ValueError):
    pass


@dataclass
class Property:
    name: str
    dtype: np.dtype = None  # atomic
    is_list: bool = False
    length_dtype: np.dtype = None
    elt_dtype: np.dtype = None


@dataclass
class Element:
    name: str
    count: int
    properties: List[Property] = field(default_factory=list)


@dataclass
class Ply:
    fmt: str
    elements: List[Element]
    data: Dict[str, Dict[str, Union[np.ndarray, list]]]


def _parse_header(buf: bytes):
    if buf[:4] != b"ply\n":
        raise PlyError(f'expected file to start with "ply\\n", got {buf[:4]!r}')
    pos = 4
    lines = []
    while True:
        nl = buf.find(b"\n", pos)
        if nl < 0:
            raise PlyError('missing "end_header" line')
        line = buf[pos:nl].decode("ascii", "replace").strip("\r")
        pos = nl + 1
        if line == "end_header":
            break
        lines.append(line)
    fmt = None
    elements: List[Element] = []
    for line in lines:
        parts = line.split(" ")
        if parts[0] == "format":
            if len(parts) != 3 or parts[2] != "1.0":
                raise PlyError(f"cannot parse format line: {line!r}")
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append(Element(parts[1], int(parts[2])))
        elif parts[0] == "property":
            if not elements:
                raise PlyError(f"property before element: {line!r}")
            if parts[1] == "list":
                _, _, lt, et, name = parts
                elements[-1].properties.append(Property(
                    name, is_list=True, length_dtype=np.dtype(_DTYPES[lt]),
                    elt_dtype=np.dtype(_DTYPES[et])))
            else:
                _, t, name = parts
                elements[-1].properties.append(
                    Property(name, dtype=np.dtype(_DTYPES[t])))
    if fmt is None:
        raise PlyError("header has no format line")
    return fmt, elements, pos


def _decode_fixed(buf, pos, elem):
    width = sum(p.dtype.itemsize for p in elem.properties)
    raw = np.frombuffer(buf, np.uint8, width * elem.count, pos)
    raw = raw.reshape(elem.count, width)
    cols = {}
    off = 0
    for p in elem.properties:
        size = p.dtype.itemsize
        view = raw[:, off:off + size].copy().view(p.dtype.newbyteorder("<"))
        cols[p.name] = view.reshape(elem.count)
        off += size
    return cols, pos + width * elem.count


def _decode_list(buf, pos, elem):
    p = elem.properties[0]
    ls = p.length_dtype.itemsize
    es = p.elt_dtype.itemsize
    # uniform-length fast path: peek the first row's length
    if elem.count == 0:
        return {p.name: np.zeros((0, 0), np.int64)}, pos
    k = int(np.frombuffer(buf, p.length_dtype.newbyteorder("<"), 1, pos)[0])
    row_bytes = ls + k * es
    total = row_bytes * elem.count
    lengths = np.frombuffer(buf, np.uint8, total, pos).reshape(
        elem.count, row_bytes)[:, :ls].copy().view(
        p.length_dtype.newbyteorder("<")).reshape(elem.count)
    if (lengths == k).all():
        raw = np.frombuffer(buf, np.uint8, total, pos).reshape(
            elem.count, row_bytes)[:, ls:].copy().view(
            p.elt_dtype.newbyteorder("<")).reshape(elem.count, k)
        return {p.name: raw.astype(np.int64)}, pos + total
    # variable-length slow path
    rows = []
    cur = pos
    for _ in range(elem.count):
        ln = int(np.frombuffer(buf, p.length_dtype.newbyteorder("<"), 1, cur)[0])
        cur += ls
        rows.append(np.frombuffer(buf, p.elt_dtype.newbyteorder("<"), ln,
                                  cur).astype(np.int64))
        cur += ln * es
    return {p.name: rows}, cur


def parse(buf: bytes) -> Ply:
    fmt, elements, pos = _parse_header(buf)
    if fmt != "binary_little_endian":
        raise PlyError(f"to do: handle format {fmt}")  # parity: ply.ml:345-350
    data = {}
    for elem in elements:
        if len(elem.properties) == 1 and elem.properties[0].is_list:
            cols, pos = _decode_list(buf, pos, elem)
        elif all(not p.is_list for p in elem.properties):
            cols, pos = _decode_fixed(buf, pos, elem)
        else:
            raise PlyError("to do: parse mixed list/non-list element")
        data[elem.name] = cols
    return Ply(fmt, elements, data)


def load(path: str) -> Ply:
    with open(path, "rb") as f:
        return parse(f.read())


def write_mesh(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Minimal binary-LE PLY writer (float vertices, uchar-length int faces)
    for tests and asset generation."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    n_v, n_f = len(vertices), len(faces)
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n_v}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element vertex_indices {n_f}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vertices.astype("<f4").tobytes())
        k = faces.shape[1]
        row = np.empty(n_f, dtype=[("n", "u1"), ("idx", "<i4", (k,))])
        row["n"] = k
        row["idx"] = faces
        f.write(row.tobytes())
