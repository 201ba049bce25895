"""Triangle-mesh BVH: the host-side build and the mesh container.

Port of the host side of pathtracer_tpu/ops/bvh.py for the BVH8 and BVH4
walks: the binned-SAH build (native.bvh_build), build_walk_table8 (the
BVH8 re-entry walk table, native, plus its reciprocal-scale columns),
build_walk_table4 (the BVH4 re-entry walk table, native) and MeshBVH
(walk="bvh8", which falls back to BVH4 past the BVH8 table's 24-bit
entries, or walk="bvh4"). The walks themselves are the CUDA kernels of
ops/cuda/bvh_walk_kernel.py (csrc/bvh8_walk.cu, csrc/bvh4_walk.cu);
MeshBVH.intersect calls its table's. The python builders, the octant
table and the skip-link walk, oracles of the JAX package, are not ported.

BVH8 walk-table layout (R, 32) f32, int columns as raw int32 bits:
  node rows [0, node_end): cols 0-2 frame origin (the node's box lo), 3-5
    per-axis scale (extent / 254), 6-17 48 uint8 quantized child bounds
    (byte 2*(3i+a) = qlo of child i, axis a; byte 2*(3i+a)+1 = qhi), 18-23 8
    entry pointers packed 24-bit little-endian (entry = row*8, bit 0 the
    last-child flag), 24 the exit pointer, 25 the arity, 26-28 the
    reciprocal scale. Octant o's rows are [o*stride, (o+1)*stride).
  triangle-pair rows [node_end, R-1): cols 0-8 a, e1, e2 of the first
    triangle, 9 its index, 10 the last-pair flag (1.0), 12-20 and 21 the
    second triangle (zero when the leaf's count is odd).
  row R-1: all zero, the absorbing done row.
Pointers are row*8 + phase. The 24-bit entries address at most 2^24 / 8 =
2,097,152 rows: about 1.5M triangles (big_ganesha's 449,352 triangles
take 572,061 rows under the ganesha camera, 1.27 a triangle), since the
node rows repeat for each of the 8 octants.

BVH4 walk-table layout (R, 32) f32, int columns as raw int32 bits:
  node rows [0, node_end): octant o's rows are [o*stride, (o+1)*stride);
    cols [6i, 6i+6) child i's world-space box (lo, hi) in the octant's
    near-first order, NaN past the arity (a NaN slab test never hits);
    int col 24+i child i's entry pointer (an inner child's row*4, or a
    leaf's first triangle-pair row*4); 28 the exit pointer; 29 the arity.
    Entering a leaf child i sets the leaf-return pointer to row*4 + i+1,
    or to the exit pointer when i is the last child.
  triangle-pair rows [node_end, R-1): the BVH8 table's.
  row R-1: all zero, the absorbing done row (pointer (R-1)*4).
Pointers are row*4 + phase (int32: at most 2^29 rows).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..utils import tracing
from .cuda.bvh_walk_kernel import bvh4_walk, bvh8_walk

__all__ = ["build_walk_table4", "build_walk_table8", "MeshBVH"]

# the walks MeshBVH takes; the JAX package's "octant" and "skiplink" stay
# its oracles
WALKS = ("bvh8", "bvh4")


def build_walk_table8(nodes_lo, nodes_hi, meta, axes, tri_a, tri_e1, tri_e2):
    """The BVH8 re-entry walk table (layout in the module docstring).
    Returns (table (R, 32) f32, node_end, stride) in rows."""
    table, node_end, stride = native.bvh8_table(nodes_lo, nodes_hi, meta,
                                                axes, tri_a, tri_e1, tri_e2)
    # reciprocal scale of node rows (triangle rows keep cols 22-31 zero)
    sc = table[:node_end, 3:6]
    table[:node_end, 26:29] = np.divide(np.float32(1.0), sc,
                                        out=np.zeros_like(sc), where=sc > 0)
    return table, node_end, stride


def build_walk_table4(nodes_lo, nodes_hi, meta, axes, tri_a, tri_e1, tri_e2):
    """The BVH4 re-entry walk table (layout in the module docstring).
    Returns (table (R, 32) f32, node_end, stride) in rows."""
    return native.bvh4_table(nodes_lo, nodes_hi, meta, axes, tri_a, tri_e1,
                             tri_e2)


# host arrays of a MeshBVH, the ones from_numpy carries across
_HOST_FIELDS = ("nodes_lo", "nodes_hi", "meta_np", "tri_a", "tri_e1",
                "tri_e2", "mat_row", "table")


class MeshBVH:
    """A triangle mesh with its walk table (BVH8, or BVH4 for a mesh past
    the BVH8 table's 24-bit entries) and one material row (the ganesha
    mesh pattern).

    Vertices must already be in camera space; mat_row is the 12-column
    material layout of scene.TRI_MAT. watertight declares the mesh a closed
    surface seen from outside, the precondition for back-face culling the
    tile lists (never inferred). walk="bvh8" builds the BVH8 table and
    falls back to the BVH4 table where the BVH8 table raises (as the JAX
    MeshBVH does); walk="bvh4" builds the BVH4 table. `walk` then holds
    the table's kind. The host arrays stay numpy; the walk table
    (`table`), the (9, T) winner-attribute pack [a | e1 | e2]
    (`tri_pack9`) and the material row (`mat_row_t`) are tensors on
    `device`. A BVH4 mesh also holds `walk_counts`, a (2,) int64 tensor on
    `device` that each walk adds its rays and table loads to (bvh4_walk's
    counts; None on a BVH8 mesh). The build (the hierarchy, the walk
    table, the upload) is one build.mesh_bvh span of utils.tracing."""

    def __init__(self, vertices, faces, mat_row, device, watertight=False,
                 walk="bvh8"):
        if walk not in WALKS:
            raise ValueError(f"walk must be one of {WALKS}, got {walk!r}")
        with tracing.span("build.mesh_bvh"):
            self._build(vertices, faces, mat_row, device, watertight, walk)

    def _build(self, vertices, faces, mat_row, device, watertight, walk):
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64)
        if faces.ndim != 2 or faces.shape[1] != 3:
            raise ValueError(f"expected triangular faces, got {faces.shape}")
        a = vertices[faces[:, 0]]
        b = vertices[faces[:, 1]]
        c = vertices[faces[:, 2]]
        lo = np.minimum(np.minimum(a, b), c)
        hi = np.maximum(np.maximum(a, b), c)
        nodes_lo, nodes_hi, meta, order, depth, axes = native.bvh_build(lo,
                                                                        hi)
        a, b, c = a[order], b[order], c[order]
        e1, e2 = b - a, c - a
        tables = (nodes_lo, nodes_hi, meta, axes, a, e1, e2)
        if walk == "bvh8":
            try:
                table, node_end, stride = build_walk_table8(*tables)
            except ValueError:  # past the 24-bit entries
                walk = "bvh4"
        if walk == "bvh4":
            table, node_end, stride = build_walk_table4(*tables)
        self._init(dict(nodes_lo=nodes_lo, nodes_hi=nodes_hi, meta_np=meta,
                        tri_a=np.ascontiguousarray(a),
                        tri_e1=np.ascontiguousarray(e1),
                        tri_e2=np.ascontiguousarray(e2),
                        mat_row=mat_row, table=table, node_end=node_end,
                        stride=stride, depth=depth, watertight=watertight,
                        walk=walk),
                   device)

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> "MeshBVH":
        """Build from the JAX MeshBVH's host arrays, so both packages walk
        the same table: `arrays` holds nodes_lo, nodes_hi, meta_np, tri_a,
        tri_e1, tri_e2, mat_row, table (the JAX `_table_np`), node_end,
        stride, depth, watertight and optionally walk, the table's kind
        ("bvh8" where it is missing, or "bvh4")."""
        self = cls.__new__(cls)
        self._init(arrays, device)
        return self

    def _init(self, arrays: dict, device):
        host = {k: np.asarray(arrays[k]) for k in _HOST_FIELDS}
        self.nodes_lo = host["nodes_lo"].astype(np.float32)
        self.nodes_hi = host["nodes_hi"].astype(np.float32)
        self.meta_np = host["meta_np"].astype(np.int32)
        self.tri_a = host["tri_a"].astype(np.float32)
        self.tri_e1 = host["tri_e1"].astype(np.float32)
        self.tri_e2 = host["tri_e2"].astype(np.float32)
        self.mat_row = host["mat_row"].astype(np.float32)
        self.table_np = np.ascontiguousarray(host["table"], np.float32)
        self.depth = int(arrays["depth"])
        self.watertight = bool(arrays["watertight"])
        self.walk = arrays.get("walk", "bvh8")
        if self.walk not in WALKS:
            raise ValueError(f"walk must be one of {WALKS}, got "
                             f"{self.walk!r}")
        self.n_tris = len(self.tri_a)
        self.bbox_lo = self.nodes_lo[0].copy()
        self.bbox_hi = self.nodes_hi[0].copy()
        self.node_end = int(arrays["node_end"])
        self.stride = int(arrays["stride"])
        self.device = torch.device(device)
        pack9 = np.concatenate([self.tri_a.T, self.tri_e1.T, self.tri_e2.T])
        self.table = torch.as_tensor(self.table_np, device=self.device)
        self.tri_pack9 = torch.as_tensor(np.ascontiguousarray(pack9),
                                         device=self.device)
        self.mat_row_t = torch.as_tensor(self.mat_row, device=self.device)
        self.walk_counts = (torch.zeros(2, dtype=torch.int64,
                                        device=self.device)
                            if self.walk == "bvh4" else None)

    def intersect(self, org, d, t_max0, active):
        """Nearest mesh hit of each ray no farther than t_max0 (the walk
        kernel of the table's kind, bvh8_walk or bvh4_walk, the latter
        adding to walk_counts; its plain version for CPU tensors). org, d
        (N, 3) f32; t_max0 (N,) f32; active (N,) bool. Returns (t, u, v,
        idx int32, hit)."""
        if self.walk == "bvh8":
            return bvh8_walk(self.table, org, d, t_max0, active,
                             self.node_end, self.stride)
        return bvh4_walk(self.table, org, d, t_max0, active, self.node_end,
                         self.stride, self.walk_counts)

    def leaf_histogram(self) -> dict:
        """leaf size -> count (the reference's leaf_length_histogram)."""
        meta = self.meta_np
        sizes, counts = np.unique(meta[meta[:, 1] > 0, 1], return_counts=True)
        return {int(s): int(c) for s, c in zip(sizes, counts)}
