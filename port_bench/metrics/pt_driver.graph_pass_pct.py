"""pt_driver.graph_pass_pct: the share of the PT driver's passes that ran
as a replayed CUDA graph, in %, over the window's untraced images: 100 x
the program's pt.graph_passes counter over its pt.passes counter (every
pass of the mesh renderer's band_sums). None where the program counts no
pass (the sphere path, or a program without these counters)."""

from port_bench import spans

LAYER = "PT driver"
MOVES = "image_s"
UNIT = "%"


def read(ctx):
    recs = spans.untraced(ctx)
    if recs is None:
        return None
    passes = sum(r.counts.get("pt.passes", 0) for r in recs)
    graphed = sum(r.counts.get("pt.graph_passes", 0) for r in recs)
    return 100.0 * graphed / passes if passes else None
