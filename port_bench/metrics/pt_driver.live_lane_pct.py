"""pt_driver.live_lane_pct: the useful share of the lanes the driver's
bounces work, in %, over the window's untraced images: 100 x the
program's pt.live_lanes counter (the live lanes of each bounce, whose sum
is the image's segments) over its pt.lanes counter (the lanes each
bounce's kernels and glue run over)."""

from port_bench import spans

LAYER = "PT driver"
MOVES = "image_s"
UNIT = "%"


def read(ctx):
    recs = spans.untraced(ctx)
    if recs is None:
        return None
    lanes = sum(r.counts.get("pt.lanes", 0) for r in recs)
    live = sum(r.counts.get("pt.live_lanes", 0) for r in recs)
    return 100.0 * live / lanes if lanes and live else None
