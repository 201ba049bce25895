"""gather_roofline: the chunk gather's share of its roofline bound, in %:
the least bytes the traced images' gathers must move, over the HBM rate,
over the device time of the kernels that run the stage (STAGE).

Bytes: each eye hit reads its point and normal (6 float32) and writes its
flux (3 float32), and each valid deposit is read once, its position,
normal and flux (9 float32): 36 B each, HIT_BYTES = DEPOSIT_BYTES = 36.
The hits and deposits are the program's ppm.eye_hits and ppm.deposits
counters of the traced images (the records from image warmup_images on),
never a chunk, list or launch shape. None where the program counts
neither."""

from port_bench import roofline, spans

LAYER = "kernels"
MOVES = "image_s"
UNIT = "%"

STAGE = ("gather_chunks_items_kernel", "gather_chunks_combine_kernel")
HIT_BYTES = 36
DEPOSIT_BYTES = 36


def read(ctx):
    mod = spans.tracing()
    if mod is None or ctx.profile is None or not ctx.traced_images:
        return None
    device_s, n = ctx.profile.device(STAGE)
    first = int(ctx.traffic.get("warmup_images", 1))
    recs = mod.images(first)[:ctx.traced_images]
    hits = sum(r.counts.get("ppm.eye_hits", 0) for r in recs)
    deposits = sum(r.counts.get("ppm.deposits", 0) for r in recs)
    if not n or not (hits or deposits):
        return None
    return roofline.share_pct(hits * HIT_BYTES + deposits * DEPOSIT_BYTES,
                              device_s)
