"""pools_roofline: the sphere and triangle pools' share of their roofline
bound, in %: the least bytes the traced images' pool queries must move,
over the HBM rate, over the device time of the kernels that run the stage
(STAGE).

A query is a ray that meets the pools: each photon segment (the program's
ppm.photon_segments counter) and each live lane of the eye walk
(ppm.walk_live). Each reads its ray once, origin and direction (6
float32), and writes its winner once, t and index (2 words):
QUERY_BYTES = 32. Each bounce of the photon pass (max_bounces an
iteration) and of the eye walk (ppm.walk_lanes / ppm.eye_lanes an
iteration) reads the pools' primitives once: a sphere's centre and radius
(SPHERE_BYTES = 16), a triangle's vertex and two edges (TRIANGLE_BYTES =
36), as many as `sizes()` gives. The counts are of the light paths' work,
never of a launch shape, so the share reads the same work whatever
implements the query. The counters are the traced images' (the records
from image warmup_images on). None where the program counts no live walk
lane (a program without that counter) or no pool kernel ran."""

from port_bench import roofline, spans

LAYER = "kernels"
MOVES = "image_s"
UNIT = "%"

STAGE = ("intersect_spheres_kernel", "intersect_tris_kernel")
QUERY_BYTES = 32
SPHERE_BYTES = 16
TRIANGLE_BYTES = 36


def read(ctx):
    mod = spans.tracing()
    if mod is None or ctx.profile is None or not ctx.traced_images:
        return None
    device_s, n = ctx.profile.device(STAGE)
    first = int(ctx.traffic.get("warmup_images", 1))
    recs = mod.images(first)[:ctx.traced_images]
    total = lambda name: sum(r.counts.get(name, 0) for r in recs)
    live, eye_lanes = total("ppm.walk_live"), total("ppm.eye_lanes")
    if not n or not live or not eye_lanes:
        return None
    walk_bounces = total("ppm.walk_lanes") // eye_lanes  # an iteration's
    bounces = total("ppm.iters") * (ctx.traffic["max_bounces"]
                                    + walk_bounces)
    pools = (ctx.sizes["spheres"] * SPHERE_BYTES
             + ctx.sizes["triangles"] * TRIANGLE_BYTES)
    queries = total("ppm.photon_segments") + live
    return roofline.share_pct(queries * QUERY_BYTES + bounces * pools,
                              device_s)
