"""The program's own spans and counters (`pathtracer_tpu_torch.utils.
tracing`), as the per-layer metrics that read them see them.

The program keeps one record per image, one per `pt.render` span, in the
order the run asked for them: the warm-up images, the device group, the
gap group, then the window's untraced images, which the per-image metrics
read. A program without the tracing module (an older checkout) gives no
record, and every such metric then reads None. So does a run without a
card: there the kernels' plain versions run on the host, inside the spans
that time the PT driver's own work.
"""

from __future__ import annotations

import torch

__all__ = ["on_card", "tracing", "untraced", "mean_ms"]


def on_card() -> bool:
    return torch.cuda.is_available()


def tracing():
    """The program's tracing module, or None where it has none or the run
    has no card."""
    if not on_card():
        return None
    try:
        from pathtracer_tpu_torch.utils import tracing as mod
    except ImportError:
        return None
    return mod


def untraced(ctx) -> list | None:
    """The records of the window's untraced images (from image
    warmup_images + trace_images + gap_images on), or None."""
    mod = tracing()
    if mod is None:
        return None
    t = ctx.traffic
    first = sum(int(t.get(k, 1)) for k in ("warmup_images", "trace_images",
                                           "gap_images"))
    return mod.images(first) or None


def mean_ms(records, names) -> float:
    """The mean over `records` of the summed total time of the spans
    `names`, in ms."""
    ns = sum(r.total_ns.get(n, 0) for r in records for n in names)
    return ns * 1e-6 / len(records)
