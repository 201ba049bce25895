"""walk4_roofline: the BVH4 mesh walk's share of its roofline bound, in %:
the least bytes the traced images' walks must move, over the HBM rate,
over the device time of the BVH4 walk kernel alone (STAGE).

walk_roofline's byte count on the program's own count of the walked
rays: each ray handed to the walk (the program's pt.walk_rays counter of
the traced images, the records from image warmup_images on) reads its
origin, direction and bound (7 float32, 28 B) and writes its t, u, v and
triangle index (16 B): RAY_BYTES = 44. Each walk of the work (one per
pass and bounce past the first, spp x (max_bounces - 1) an image) reads
the mesh's triangles once, 3 vertices of 3 float32: TRIANGLE_BYTES = 36.
None where the program counts no walked ray (a program without the
counter, or a mesh on the BVH8 walk) or no BVH4 walk kernel ran."""

from port_bench import roofline, spans

LAYER = "kernels"
MOVES = "image_s"
UNIT = "%"

STAGE = ("bvh4_walk_kernel",)
RAY_BYTES = 44
TRIANGLE_BYTES = 36


def read(ctx):
    mod = spans.tracing()
    if mod is None or ctx.profile is None or not ctx.traced_images:
        return None
    device_s, n = ctx.profile.device(STAGE)
    first = int(ctx.traffic.get("warmup_images", 1))
    recs = mod.images(first)[:ctx.traced_images]
    rays = sum(r.counts.get("pt.walk_rays", 0) for r in recs)
    if not n or not rays:
        return None
    t = ctx.traffic
    walks = ctx.traced_images * t["spp"] * (t["max_bounces"] - 1)
    n_bytes = (rays * RAY_BYTES
               + walks * ctx.sizes["mesh_triangles"] * TRIANGLE_BYTES)
    return roofline.share_pct(n_bytes, device_s)
