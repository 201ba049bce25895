"""ppm_driver.host_ms_per_image: the host's own work per untraced image of
the window, in ms: the program's ppm.render span less its ppm.sync spans
(the host blocked on the device), that is Python and dispatch."""

from port_bench import spans

LAYER = "PPM driver"
MOVES = "image_s"
UNIT = "ms"


def read(ctx):
    recs = spans.untraced(ctx)
    if recs is None:
        return None
    return (spans.mean_ms(recs, ("ppm.render",))
            - spans.mean_ms(recs, ("ppm.sync",)))
