"""The host-side build tier: native/bvh_build.cc, built with g++ and loaded
with ctypes.

Port of pathtracer_tpu/native/__init__.py for the four functions the port
runs: the binned-SAH BVH build (bvh_build2), the BVH8 and BVH4 walk tables
(bvh8_table_rows / bvh8_table_fill, bvh4_table_rows / bvh4_table_fill) and
the BVH-guided per-tile frustum cull (tile_cull_bvh). The library is built
at first use with `g++ -O3 -march=native -shared -fPIC -pthread` into the
package's git-ignored `_build/` directory, under a name hashed from the
source and the flags, as `_build.py` builds the CUDA kernels. A missing
or failing g++ raises: unlike the JAX package, the port has no pure-numpy
fallback (about 100x slower on the ganesha mesh, and it would hide the
failure).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "bvh_build.cc")
_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "_build")
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]
# the binned-SAH build's settings, the JAX MeshBVH's defaults: leaves of at
# most 8 triangles, 32 bins, intersection and traversal costs 1 and 0.25
LENGTH_CUTOFF, NUM_BINS, COST_I, COST_T = 8, 32, 1.0, 0.25

_lib = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_OUT, f"libbvh_{h.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; cached per process."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(_OUT, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            res = subprocess.run(["g++", *FLAGS, _SRC, "-o", tmp],
                                 capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: cannot build "
                               "native/bvh_build.cc") from e
        if res.returncode:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    c_int, c_float = ctypes.c_int, ctypes.c_float
    lib.bvh_build2.argtypes = [f32p, f32p, c_int, c_int, c_int, c_float,
                               c_float, f32p, f32p, i32p, i32p, i32p, i32p]
    lib.bvh_build2.restype = c_int
    for width in (4, 8):
        rows_fn = getattr(lib, f"bvh{width}_table_rows")
        rows_fn.argtypes = [i32p, c_int, i32p]
        rows_fn.restype = ctypes.c_int64
        fill_fn = getattr(lib, f"bvh{width}_table_fill")
        fill_fn.argtypes = [f32p, f32p, i32p, i32p, c_int, f32p, f32p, f32p,
                            c_int, f32p, ctypes.c_int64, ctypes.c_int32]
        fill_fn.restype = None
    lib.tile_cull_bvh.argtypes = [f32p, f32p, i32p, c_int, f32p, f32p, f32p,
                                  c_int, f64p, c_int, c_int, ctypes.c_double,
                                  u8p]
    lib.tile_cull_bvh.restype = None
    _lib = lib
    return lib


def bvh_build(prim_lo, prim_hi, length_cutoff=LENGTH_CUTOFF,
              num_bins=NUM_BINS):
    """Binned-SAH build from per-primitive boxes, with leaves of at most
    length_cutoff primitives and num_bins bins per axis (the defaults are
    the mesh's). Returns (nodes_lo (M, 3),
    nodes_hi (M, 3), meta (M, 3) int32 [first, count, skip], order (T,)
    int64 primitive permutation, depth, axes (M,) int32, -1 for leaves)."""
    lib = load()
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    n = len(lo)
    cap = max(2 * n, 4)
    nodes_lo = np.empty((cap, 3), np.float32)
    nodes_hi = np.empty((cap, 3), np.float32)
    meta = np.empty((cap, 3), np.int32)
    order = np.empty(n, np.int32)
    depth = np.zeros(1, np.int32)
    axes = np.empty(cap, np.int32)
    m = lib.bvh_build2(lo, hi, n, int(length_cutoff), int(num_bins), COST_I,
                       COST_T, nodes_lo, nodes_hi, meta, order, depth, axes)
    return (nodes_lo[:m].copy(), nodes_hi[:m].copy(), meta[:m].copy(),
            order.astype(np.int64), int(depth[0]), axes[:m].copy())


def _wide_table(width, nodes_lo, nodes_hi, meta, axes, tri_a, tri_e1,
                tri_e2):
    """The BVH4 or BVH8 walk table (bvh{width}_table_rows / _fill; the JAX
    _bvh_wide_table_native). Returns (table (R, 32) f32, node_end, stride),
    both in rows; node_end is 8 * stride."""
    lib = load()
    meta = np.ascontiguousarray(meta, np.int32)
    axes = np.ascontiguousarray(axes, np.int32)
    m = meta.shape[0]
    stride = np.zeros(1, np.int32)
    rows = getattr(lib, f"bvh{width}_table_rows")(meta, m, stride)
    if width == 8 and rows * 8 >= 1 << 24:
        raise ValueError(f"mesh too large for 24-bit BVH8 entries ({rows} "
                         "rows)")
    if rows * width >= 1 << 31:  # the fill writes int32 pointers
        raise ValueError(f"mesh too large for int32 BVH{width} pointers "
                         f"({rows} rows)")
    table = np.empty((rows, 32), np.float32)
    getattr(lib, f"bvh{width}_table_fill")(
        np.ascontiguousarray(nodes_lo, np.float32),
        np.ascontiguousarray(nodes_hi, np.float32), meta, axes, m,
        np.ascontiguousarray(tri_a, np.float32),
        np.ascontiguousarray(tri_e1, np.float32),
        np.ascontiguousarray(tri_e2, np.float32), len(tri_a), table, rows,
        int(stride[0]))
    return table, 8 * int(stride[0]), int(stride[0])


def bvh8_table(nodes_lo, nodes_hi, meta, axes, tri_a, tri_e1, tri_e2):
    """The BVH8 walk table without its reciprocal-scale columns (see
    ops/bvh.build_walk_table8). Returns (table (R, 32) f32, node_end,
    stride), both in rows. Raises ValueError past the 24-bit entry range
    (2^24 / 8 = 2,097,152 rows), before any allocation."""
    return _wide_table(8, nodes_lo, nodes_hi, meta, axes, tri_a, tri_e1,
                       tri_e2)


def bvh4_table(nodes_lo, nodes_hi, meta, axes, tri_a, tri_e1, tri_e2):
    """The BVH4 walk table (see ops/bvh.build_walk_table4), equal bit for
    bit to the JAX bvh4_table_native. Returns (table (R, 32) f32,
    node_end, stride), both in rows. Its pointers are int32 row*4 + phase,
    so it raises ValueError past 2^29 rows."""
    return _wide_table(4, nodes_lo, nodes_hi, meta, axes, tri_a, tri_e1,
                       tri_e2)


def tile_cull(nodes_lo, nodes_hi, meta, lo, hi, margin, planes):
    """BVH-guided per-tile frustum cull (tile_cull_bvh). Returns a (t_n, n)
    bool keep matrix, a conservative superset of the brute-force p-vertex
    test's accepts. planes: (t_n, n_planes, 3) f64 inward cone normals."""
    lib = load()
    nodes_lo = np.ascontiguousarray(nodes_lo, np.float32)
    nodes_hi = np.ascontiguousarray(nodes_hi, np.float32)
    meta = np.ascontiguousarray(meta, np.int32)
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    margin = np.ascontiguousarray(margin, np.float32)
    planes = np.ascontiguousarray(planes, np.float64)
    t_n, n_planes = planes.shape[0], planes.shape[1]
    m, n = meta.shape[0], lo.shape[0]
    # node slack must cover the largest per-tri margin in any subtree (plus
    # the rounding the margins were sized for, inside the 1.2x leaf factor)
    node_slack = 2.0 * float(margin.max()) if n else 0.0
    keep = np.zeros((t_n, n), np.uint8)
    lib.tile_cull_bvh(nodes_lo, nodes_hi, meta, m, lo, hi, margin, n, planes,
                      t_n, n_planes, node_slack, keep)
    return keep.view(bool)
