"""pt_driver.rebuild_ms_per_image: set-up work the driver redoes per
untraced image of the window, in ms: the program's pt.renderer_init
(the renderer, its tile lists or tile table and buffers) and
pt.sphere_bvh spans, which do not nest. 0 where the renderer is kept
from image to image."""

from port_bench import spans

LAYER = "PT driver"
MOVES = "image_s"
UNIT = "ms"


def read(ctx):
    recs = spans.untraced(ctx)
    if recs is None:
        return None
    return spans.mean_ms(recs, ("pt.renderer_init", "pt.sphere_bvh"))
