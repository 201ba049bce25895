"""pt_driver.ops_per_image: device operations (kernels, copies, fills) per
traced image, from the profiler's trace. Each is one dispatch of the host,
so this counts the host's dispatch load of the path tracer's driver."""

LAYER = "PT driver"
MOVES = "image_s"
UNIT = "ops/image"


def read(ctx):
    if ctx.profile is None or not ctx.traced_images:
        return None
    n = ctx.profile.device(None)[1]
    return n / ctx.traced_images if n else None
