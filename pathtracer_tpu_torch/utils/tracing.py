"""Host spans and work counters of the path tracer's render loop and its
set-up.

`span(name)` times a stage on the host; `count(name, n)` adds n to a
counter. Both go to a record: each render span (one per image: `pt.render`,
ROOT, of the path tracer, or `ppm.render`, PPM_ROOT, of the photon mapper)
opens a new image record, and spans and counts outside any render (scene
builds, the kernel library's load) go to one set-up record. A record
holds, by name, each span's total time and self time (its time less that
of its child spans), in nanoseconds, and each counter's sum.

Times are time.time_ns() readings, the clock of torch.profiler's events.
While a torch profiler runs, a span also opens a range of its name inside
its own two readings, and its record keeps the span's interval (name,
parent span's name, start ns, end ns). The range is torch's
_RecordFunctionFast, which makes no dispatcher call: on an H100 machine's
host a span took 2-4 us under a profiler of the card alone or of the host
too, against 13-14 us with a torch.profiler.record_function range. With
no profiler running a span makes no call into PyTorch: it reads the clock
twice and updates its record (about 1 us).

Records stay in memory and nothing is written to a file: the set-up
record, the first image's and the last KEEP images'. Like the profiler's
state they belong to the process, and the renderer enters its spans from
one thread; `reset()` starts a new store.
"""

from __future__ import annotations

import time
from collections import deque

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

__all__ = ["ROOT", "PPM_ROOT", "ROOTS", "KEEP", "Record", "span", "count",
           "counts", "images", "first_image", "setup", "reset"]

ROOT = "pt.render"
PPM_ROOT = "ppm.render"
ROOTS = frozenset({ROOT, PPM_ROOT})
KEEP = 4096

_now = time.time_ns


class Record:
    """One image's spans and counters (or the set-up's): total_ns and
    self_ns by span name, counts by counter name, and the intervals of the
    spans that ran under a profiler."""

    __slots__ = ("total_ns", "self_ns", "counts", "intervals")

    def __init__(self):
        self.total_ns: dict[str, int] = {}
        self.self_ns: dict[str, int] = {}
        self.counts: dict[str, int] = {}
        self.intervals: list[tuple[str, str | None, int, int]] = []

    def seconds(self, name: str) -> float:
        """The total seconds of the spans named `name` (0 for none)."""
        return self.total_ns.get(name, 0) * 1e-9


class _Store:
    def __init__(self):
        self.setup = Record()
        self.first: Record | None = None
        self.images: deque[Record] = deque(maxlen=KEEP)
        self.n_images = 0
        self.current = self.setup
        # the open spans, innermost last: [name, start_ns, child_ns, range,
        # the record that was current before a render span (else None)]
        self.stack: list[list] = []


_store = _Store()


class _Span:
    __slots__ = ("name", "root")

    def __init__(self, name: str):
        self.name = name
        self.root = name in ROOTS

    def __enter__(self):
        s = _store
        prev = None
        if self.root:
            prev, s.current = s.current, Record()
        t0 = _now()
        rng = None
        if _profiler._is_profiler_enabled:
            rng = _RecordFunctionFast(self.name)
            rng.__enter__()
        s.stack.append([self.name, t0, 0, rng, prev])
        return self

    def __exit__(self, *exc):
        s = _store
        name, t0, child, rng, prev = s.stack.pop()
        if rng is not None:
            rng.__exit__(None, None, None)
        t1 = _now()
        dt = t1 - t0
        rec = s.current
        rec.total_ns[name] = rec.total_ns.get(name, 0) + dt
        rec.self_ns[name] = rec.self_ns.get(name, 0) + dt - child
        if rng is not None:
            rec.intervals.append((name, s.stack[-1][0] if s.stack else None,
                                  t0, t1))
        if s.stack:
            s.stack[-1][2] += dt
        if prev is not None:
            s.current = prev
            s.n_images += 1
            if s.first is None:
                s.first = rec
            s.images.append(rec)
        return False


_spans: dict[str, _Span] = {}


def span(name: str) -> _Span:
    """A context manager that times the stage `name` (one object per name,
    so entering it allocates no span object)."""
    sp = _spans.get(name)
    if sp is None:
        sp = _spans[name] = _Span(name)
    return sp


def count(name: str, value: int) -> None:
    """Add `value` to the counter `name` of the current record."""
    c = _store.current.counts
    c[name] = c.get(name, 0) + value


def counts() -> dict[str, int]:
    """The counters of the current record (the open image's, else the
    set-up's), by name."""
    return _store.current.counts


def images(start: int = 0) -> list[Record]:
    """The kept image records from image `start` on, in order (image 0 is
    the process's first render span, or the first since reset())."""
    s = _store
    first_kept = s.n_images - len(s.images)
    return list(s.images)[max(0, start - first_kept):]


def first_image() -> Record | None:
    """The first image's record, kept whatever came after it."""
    return _store.first


def setup() -> Record:
    """The record of the spans and counts outside any image."""
    return _store.setup


def reset() -> None:
    """Drop every record. Not while a span is open."""
    global _store
    _store = _Store()
