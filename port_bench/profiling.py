"""The traced run's reading of torch.profiler traces: how long the device
was busy in the traced images, its operations by name, and its idle gaps
named by what the host was doing.

A traced run profiles its images in two groups of its own:
- the device group (`start(host=False)`): the card's activity alone, so
  that the host runs at close to its untraced speed. Its reading gives
  the device's busy time, its operations, and the group's length on the
  host clock (from a synchronized start to a synchronized end);
- the gap group (`start(host=True)`): the host's operators too, inside a
  host span named WINDOW, to name each idle gap by what the host was
  doing. Recording the host's operators slows this host-bound program
  several-fold, so the gaps' lengths are inflated: they rank the gaps'
  causes, and no share is taken from them.

The benchmark's own spans (`port_bench.render`, `port_bench.to_host`) say
which part of an image the host was in. Only aggregates leave this
module: no trace file is written.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

__all__ = ["WINDOW", "SPAN", "Profile", "summarize", "start", "read_device",
           "read_gaps"]

WINDOW = "port_bench.traced"
SPAN = "port_bench."
NAME_CHARS = 160  # a kernel's name in the breakdown is cut to this length


@dataclass
class Profile:
    """window_s: the traced window's length; busy_s: the union of the device
    operations' intervals inside it; ops: (name, seconds) of each device
    operation (kernel, copy, fill) inside it; gaps: (what the host was
    doing, seconds) of each stretch inside it with no device operation."""

    window_s: float
    busy_s: float
    ops: list
    gaps: list

    def device(self, names) -> tuple[float, int]:
        """Seconds and count of the operations whose name holds one of
        `names` (all operations for None)."""
        hit = [s for n, s in self.ops
               if names is None or any(k in n for k in names)]
        return sum(hit), len(hit)

    def outside(self, names) -> tuple[float, int]:
        """Seconds and count of the operations whose name holds none of
        `names`."""
        hit = [s for n, s in self.ops if not any(k in n for k in names)]
        return sum(hit), len(hit)

    @staticmethod
    def _top(rows, k):
        total = defaultdict(float)
        for name, s in rows:
            total[name] += s
        return sorted(([n, s] for n, s in total.items()),
                      key=lambda r: -r[1])[:k]

    def breakdown(self, k: int = 10) -> dict:
        """The result line's breakdown: device operations and idle gaps,
        each summed by name, the k largest."""
        return {"device_ops": [[n[:NAME_CHARS], s]
                               for n, s in self._top(self.ops, k)],
                "idle_gaps": self._top(self.gaps, k)}


def _host_name(stack) -> str:
    """`<benchmark span>/<innermost operator>` of a host stack (outermost
    first); CUDA runtime calls are skipped for the operator."""
    span = next((e[0][len(SPAN):] for e in reversed(stack)
                 if e[0].startswith(SPAN) and e[0] != WINDOW),
                "between_spans")
    op = next((e[0] for e in reversed(stack)
               if not e[0].startswith(SPAN) and not e[0].startswith("cu")),
              None)
    return span if op is None else f"{span}/{op}"


def summarize(device_ops, host_ops, window) -> Profile:
    """device_ops, host_ops: (name, start_us, end_us); host_ops of the
    thread that ran the window, properly nested; window: (start_us,
    end_us)."""
    w0, w1 = window
    ops, spans = [], []
    for name, s, e in device_ops:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            ops.append((name, (e - s) * 1e-6))
            spans.append((s, e))
    spans.sort()
    busy, gaps_at = 0.0, []
    cur = w0
    for s, e in spans:
        if s > cur:
            gaps_at.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if w1 > cur:
        gaps_at.append((cur, w1))
    hosts = sorted(host_ops, key=lambda h: (h[1], -h[2]))
    stack, j, gaps = [], 0, []
    for g0, g1 in gaps_at:
        while j < len(hosts) and hosts[j][1] <= g0:
            while stack and stack[-1][2] <= hosts[j][1]:
                stack.pop()
            stack.append(hosts[j])
            j += 1
        while stack and stack[-1][2] <= g0:
            stack.pop()
        gaps.append((_host_name(stack), (g1 - g0) * 1e-6))
    return Profile((w1 - w0) * 1e-6, busy * 1e-6, ops, gaps)


def start(host: bool):
    """A started profiler of the card, and of the host's operators where
    `host` or where there is no card (a trace of no device operation)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    card = torch.cuda.is_available()
    acts = ([ProfilerActivity.CUDA] if card else []) + (
        [ProfilerActivity.CPU] if host or not card else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _events(prof):
    """(name, on the device, start_us, end_us, thread, is an annotation) of
    each event of a stopped profiler, from its raw results (building the
    profiler's own event tree takes tens of seconds on a mesh image)."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        yield (e.name(), e.device_type() == DeviceType.CUDA,
               e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.start_thread_id(),
               e.is_user_annotation())


def _device_ops(events):
    return [(n, s, e) for n, dev, s, e, _, ann in events
            if dev and not ann and not n.startswith(SPAN)]


def read_device(prof, window_s: float) -> Profile:
    """The Profile of a stopped device group whose images took `window_s`
    on the host clock; it names no gaps."""
    ops = _device_ops(list(_events(prof)))
    if not ops:
        return Profile(window_s, 0.0, [], [])
    p = summarize(ops, [], (min(o[1] for o in ops), max(o[2] for o in ops)))
    return Profile(window_s, p.busy_s, p.ops, [])


def read_gaps(prof) -> list | None:
    """The idle gaps, named, of a stopped gap group, or None where its
    trace holds no WINDOW span."""
    events = list(_events(prof))
    win = [e for e in events if e[0] == WINDOW and not e[1]]
    if not win:
        return None
    _, _, w0, w1, thread, _ = win[0]
    host = [(n, s, e) for n, dev, s, e, t, _ in events
            if not dev and t == thread]
    return summarize(_device_ops(events), host, (w0, w1)).gaps
