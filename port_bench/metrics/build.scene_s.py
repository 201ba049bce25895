"""build.scene_s: host seconds of the set-up's scene-build calls (the
sphere list and scene of a seed, or the mesh's load, hierarchy and walk
table), on the benchmark's clock around them."""

LAYER = "scene build"
MOVES = "setup_s"
UNIT = "s"


def read(ctx):
    return ctx.build_s
