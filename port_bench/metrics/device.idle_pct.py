"""device.idle_pct: the share of an untraced image's time in which no
operation ran on the device, in %: 1 - (the device group's busy time per
image, from the profiler's trace of the card alone) / (image_s of the
window's untraced images). Both readings come from the same run; the
denominator carries no profiler cost."""

LAYER = "device"
MOVES = "image_s"
UNIT = "%"


def read(ctx):
    p = ctx.profile
    if p is None or p.busy_s <= 0 or not ctx.traced_images \
            or not ctx.untraced_image_s:
        return None
    busy = p.busy_s / ctx.traced_images
    return 100.0 * (1.0 - busy / ctx.untraced_image_s)
