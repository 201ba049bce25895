"""bounce_roofline: the bounce stage's share of its roofline bound, in %:
the least bytes the traced images' bounces must move, over the HBM rate,
over the device time of the kernels that run the stage (STAGE).

Bytes: each segment (a live path at one bounce) reads its origin,
direction and attenuation (9 float32, 36 B) and its sample offset (4 B),
and writes the next origin, direction and attenuation (36 B) and its
radiance (3 float32, 12 B): SEGMENT_BYTES = 88. Each bounce of each pass
reads the scene's spheres once: centre and radius, material kind, albedo
and index of refraction (9 float32), SPHERE_BYTES = 36. The segments are
the program's count, which the comparison holds to the reference's."""

from port_bench import roofline

LAYER = "kernels"
MOVES = "image_s"
UNIT = "%"

STAGE = ("fused_bounce_kernel", "intersect_state_kernel", "shade_kernel")
SEGMENT_BYTES = 88
SPHERE_BYTES = 36


def read(ctx):
    if ctx.profile is None or not ctx.traced_images:
        return None
    device_s, n = ctx.profile.device(STAGE)
    if not n:
        return None
    t = ctx.traffic
    spheres = (ctx.traced_images * t["spp"] * t["max_bounces"]
               * ctx.sizes["spheres"] * SPHERE_BYTES)
    return roofline.share_pct(ctx.traced_segments * SEGMENT_BYTES + spheres,
                              device_s)
