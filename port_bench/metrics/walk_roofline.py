"""walk_roofline: the mesh walk's share of its roofline bound, in %: the
least bytes the traced images' walks must move, over the HBM rate, over
the device time of the kernels that run the stage (STAGE).

The rays that meet the mesh by the walk are the segments less the
W x H x spp primaries, which meet it through the tile kernel. Bytes: each
such ray reads its origin, direction and bound (7 float32, 28 B) and
writes its t, u, v and triangle index (16 B): RAY_BYTES = 44. Each walk
of the work (one per pass and bounce past the first) reads the mesh's
triangles once, 3 vertices of 3 float32: TRIANGLE_BYTES = 36."""

from port_bench import roofline

LAYER = "kernels"
MOVES = "image_s"
UNIT = "%"

STAGE = ("bvh8_walk_kernel", "bvh4_walk_kernel")
RAY_BYTES = 44
TRIANGLE_BYTES = 36


def read(ctx):
    if ctx.profile is None or not ctx.traced_images:
        return None
    device_s, n = ctx.profile.device(STAGE)
    if not n:
        return None
    t = ctx.traffic
    primaries = t["width"] * t["height"] * t["spp"]
    rays = ctx.traced_segments - ctx.traced_images * primaries
    walks = ctx.traced_images * t["spp"] * (t["max_bounces"] - 1)
    n_bytes = (rays * RAY_BYTES
               + walks * ctx.sizes["mesh_triangles"] * TRIANGLE_BYTES)
    return roofline.share_pct(n_bytes, device_s)
