"""build.scene_span_s: the program's build.scene spans of the set-up, in
s: the scene-build calls that build.scene_s times on the benchmark's clock
around them (the sphere list and scene of a seed, or the mesh's load,
hierarchy and walk table), timed by the program itself."""

from port_bench import spans

LAYER = "scene build"
MOVES = "setup_s"
UNIT = "s"


def read(ctx):
    mod = spans.tracing()
    return (mod.setup().seconds("build.scene") or None) if mod else None
