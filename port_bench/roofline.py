"""The table of peaks and the roofline arithmetic of the per-layer metrics.

A stage's bound is the least time its work could take on the card: the
bytes it must read and write, each once, over the published HBM rate of
an NVIDIA H100 SXM (3.35 TB/s; NVIDIA's data sheet, at the card's full 700
W). The bytes are counted from the light paths' work and the scene's
sizes, never from a hierarchy, a table or a launch shape of the program,
so that a rewrite of the stage reads the same work. Its share is the bound
over the device time of the stage's kernels, in percent.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "bound_s", "share_pct"]

HBM_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S


def share_pct(n_bytes: float, device_s: float):
    """100 x bound / device time, or None where no device time was read."""
    if device_s <= 0:
        return None
    return 100.0 * bound_s(n_bytes) / device_s
