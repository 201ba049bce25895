"""build.first_render_s: the program's first pt.render span, in s: the
run's first warm-up image, with what the first render does once (the
kernel library's load or build, the first renderer and sphere hierarchy
or tile table, first-use costs of the device and its libraries)."""

from port_bench import spans

LAYER = "scene build"
MOVES = "setup_s"
UNIT = "s"


def read(ctx):
    mod = spans.tracing()
    first = mod.first_image() if mod is not None else None
    return first.seconds(mod.ROOT) if first is not None else None
