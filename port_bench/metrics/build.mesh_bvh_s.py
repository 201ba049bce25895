"""build.mesh_bvh_s: the program's build.mesh_bvh spans of the set-up, in
s: the mesh's hierarchy (the native build), its walk table (the BVH8
table's attempt and, past its range, the BVH4 table) and their upload,
inside build.scene_span_s's build.scene span. None where the program has
no such span."""

from port_bench import spans

LAYER = "scene build"
MOVES = "setup_s"
UNIT = "s"


def read(ctx):
    mod = spans.tracing()
    return (mod.setup().seconds("build.mesh_bvh") or None) if mod else None
