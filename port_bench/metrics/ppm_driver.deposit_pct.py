"""ppm_driver.deposit_pct: the share of the photon map's rows that hold a
photon, in %, over the window's untraced images: 100 x the program's
ppm.deposits counter (the valid deposits) over its ppm.deposit_rows
counter (every (bounce, lane) slot, which the chunk build and its sort
work over). None where the program counts no deposit row."""

from port_bench import spans

LAYER = "PPM driver"
MOVES = "image_s"
UNIT = "%"


def read(ctx):
    recs = spans.untraced(ctx)
    if recs is None:
        return None
    rows = sum(r.counts.get("ppm.deposit_rows", 0) for r in recs)
    deposits = sum(r.counts.get("ppm.deposits", 0) for r in recs)
    return 100.0 * deposits / rows if rows else None
