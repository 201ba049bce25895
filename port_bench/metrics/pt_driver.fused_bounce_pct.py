"""pt_driver.fused_bounce_pct: the share of the mesh path tracer's
bounces that ran as its hand-written bounce kernels, in %, over the
window's untraced images: 100 x the program's pt.fused_bounces counter
over its pt.mesh_bounces counter (every bounce of integrator.trace; a
replayed pass adds what its capture counted). 0 where the eager plain
version ran them; None where the program counts no mesh bounce (the
sphere path, or a program without these counters)."""

from port_bench import spans

LAYER = "PT driver"
MOVES = "image_s"
UNIT = "%"


def read(ctx):
    recs = spans.untraced(ctx)
    if recs is None:
        return None
    bounces = sum(r.counts.get("pt.mesh_bounces", 0) for r in recs)
    fused = sum(r.counts.get("pt.fused_bounces", 0) for r in recs)
    return 100.0 * fused / bounces if bounces else None
