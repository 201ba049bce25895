"""Terminal progress reporting, mirroring the reference's `progress` bar
(render_command.ml:83-104): spinner + elapsed + ASCII bar + percentage,
refreshed at most every 0.2 s.

Copy of pathtracer_tpu/utils/progress.py (stdlib only)."""

from __future__ import annotations

import sys
import time

_SPIN = "|/-\\"


class ProgressBar:
    def __init__(self, total: int, min_interval: float = 0.2, out=None):
        self.total = max(1, total)
        self.done = 0
        self.min_interval = min_interval
        self.out = out or sys.stderr
        self.start = time.monotonic()
        self.last_draw = 0.0
        self.ticks = 0

    def update(self, n: int) -> None:
        self.done += n
        now = time.monotonic()
        if now - self.last_draw >= self.min_interval or self.done >= self.total:
            self.last_draw = now
            self._draw(now)

    def _draw(self, now: float) -> None:
        frac = min(1.0, self.done / self.total)
        elapsed = now - self.start
        width = 40
        filled = int(frac * width)
        bar = "#" * filled + "-" * (width - filled)
        spin = _SPIN[self.ticks % len(_SPIN)]
        self.ticks += 1
        self.out.write(f"\r{spin} {elapsed:6.1f}s [{bar}] {frac * 100:5.1f}%")
        self.out.flush()

    def close(self) -> None:
        self._draw(time.monotonic())
        self.out.write("\n")
        self.out.flush()
