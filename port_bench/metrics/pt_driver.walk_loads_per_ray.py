"""pt_driver.walk_loads_per_ray: the table rows the BVH4 mesh walk loads
a ray, over the window's untraced images: the program's pt.walk_loads
counter (the walk kernel's table loads, its loop iterations: a node row
not in its path cache, or a leaf's next two triangle-pair rows) over its
pt.walk_rays counter (the rays handed to the walk). None where the
program counts no load (a program without the counter, a mesh on the
BVH8 walk, or the plain walk off the card)."""

from port_bench import spans

LAYER = "PT driver"
MOVES = "image_s"
UNIT = "rows/ray"


def read(ctx):
    recs = spans.untraced(ctx)
    if recs is None or not any("pt.walk_loads" in r.counts for r in recs):
        return None
    rays = sum(r.counts.get("pt.walk_rays", 0) for r in recs)
    loads = sum(r.counts.get("pt.walk_loads", 0) for r in recs)
    return loads / rays if rays else None
