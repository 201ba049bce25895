"""ppm_driver.graph_iter_pct: the share of the PPM driver's iterations
whose photon pass, chunk build and eye walk ran as a replayed CUDA graph,
in %, over the window's untraced images: 100 x the program's
ppm.graph_iters counter over its ppm.iters counter (every iteration of a
PPMRenderer render). None where the program counts no iteration (the path
tracer, or a program without these counters)."""

from port_bench import spans

LAYER = "PPM driver"
MOVES = "image_s"
UNIT = "%"


def read(ctx):
    recs = spans.untraced(ctx)
    if recs is None:
        return None
    iters = sum(r.counts.get("ppm.iters", 0) for r in recs)
    graphed = sum(r.counts.get("ppm.graph_iters", 0) for r in recs)
    return 100.0 * graphed / iters if iters else None
