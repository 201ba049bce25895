"""pt_driver.host_ms_per_image: the host's own work per untraced image of
the window, in ms: the program's pt.render span less its pt.sync spans
(the host blocked on the device), that is Python and dispatch."""

from port_bench import spans

LAYER = "PT driver"
MOVES = "image_s"
UNIT = "ms"


def read(ctx):
    recs = spans.untraced(ctx)
    if recs is None:
        return None
    return (spans.mean_ms(recs, ("pt.render",))
            - spans.mean_ms(recs, ("pt.sync",)))
