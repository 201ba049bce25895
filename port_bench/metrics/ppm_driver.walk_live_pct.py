"""ppm_driver.walk_live_pct: the useful share of the lanes the eye walk
runs over, in %, over the window's untraced images: 100 x the program's
ppm.walk_live counter (the eye lanes live as each walk bounce begins,
summed over the bounces and bands) over its ppm.walk_lanes counter (the
lanes each walk bounce runs over: eye lanes x walk bounces). The rest are
the dead lanes that a compaction of the walk would drop. None where the
program counts no walk lane (a program without these counters)."""

from port_bench import spans

LAYER = "PPM driver"
MOVES = "image_s"
UNIT = "%"


def read(ctx):
    recs = spans.untraced(ctx)
    if recs is None:
        return None
    lanes = sum(r.counts.get("ppm.walk_lanes", 0) for r in recs)
    live = sum(r.counts.get("ppm.walk_live", 0) for r in recs)
    return 100.0 * live / lanes if lanes else None
