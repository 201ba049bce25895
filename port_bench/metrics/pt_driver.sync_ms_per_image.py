"""pt_driver.sync_ms_per_image: the host's time blocked on the device per
untraced image of the window, in ms: the program's pt.sync spans (the
compaction's read of its row count, the image's closing read)."""

from port_bench import spans

LAYER = "PT driver"
MOVES = "image_s"
UNIT = "ms"


def read(ctx):
    recs = spans.untraced(ctx)
    return None if recs is None else spans.mean_ms(recs, ("pt.sync",))
