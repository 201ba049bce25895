"""CUDA-graph replay of a renderer's repeated work: a path tracer's pass
(integrator: a Renderer's or a MeshRenderer's) and a PPMRenderer
iteration's prefix (ppm).

Both are the same for every pass or iteration of a renderer but for a
few integers (the pass index; the photon and eye offsets), read nothing
back to the host and have shapes fixed for the renderer, so one CUDA graph
holds each, and a replay costs the host one launch where the eager work
issues a few thousand operations. The graph runs the same kernels in the
same order on the same inputs, so its results are the eager ones bit for
bit.

Replay follows PyTorch's recipe. Its first call is the warm-up, eager on a
side stream (the kernel library's load and every first launch happen
there; its result is that call's, so nothing is thrown away); then
torch.cuda.graph captures the same work into the graph's own memory pool.
The integers are static 0-dim int64 tensors, filled before each call, so
one graph serves every call.

A replay runs none of the captured Python, so what that Python counts is
kept here: the capture ran it without launching anything, and the
launches of every kernel wrapper and the tracing counters of the current
record that it added are taken back and kept as the graph's deltas. Each
replay is one `<prefix>.replay` span, adds both deltas and counts the
replay counter; the capture is one `<prefix>.capture` span.

The renderers import this module only where a card first needs a graph, so
the CPU never loads it.
"""

from __future__ import annotations

import torch

from .ops.cuda import kernel_wrappers
from .utils import tracing

__all__ = ["Replay"]


class Replay:
    """fn(owner, *inputs) as a CUDA graph on `device`: inputs are `n_inputs`
    static 0-dim int64 tensors. The graph is captured at the first call and
    replayed at every later one; `prefix` names its spans (`pt`, `ppm`) and
    `counter` counts its replays. It keeps no reference to the owner, which
    holds the graph and passes itself at each call, so dropping the owner
    frees the graph and its pool."""

    def __init__(self, fn, n_inputs: int, device, prefix: str, counter: str):
        self.fn, self.device, self.counter = fn, device, counter
        self.inputs = [torch.zeros((), dtype=torch.int64, device=device)
                       for _ in range(n_inputs)]
        self.capture_span = prefix + ".capture"
        self.replay_span = prefix + ".replay"
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out = None  # the captured call's outputs
        self.launches: dict = {}  # wrapper -> its launches in one call
        self.counts: dict = {}  # tracing counter -> its sum in one call

    def _warm_up_and_capture(self, owner):
        """Run fn eagerly on a side stream and return its outputs, then
        capture it and take back what the capture counted."""
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.fn(owner, *self.inputs)
        main.wait_stream(side)
        launches = {f: f.launches for f in kernel_wrappers()}
        counts = dict(tracing.counts())
        graph = torch.cuda.CUDAGraph()
        with tracing.span(self.capture_span), torch.cuda.graph(graph):
            self.out = self.fn(owner, *self.inputs)
        for f, n in launches.items():
            if f.launches != n:
                self.launches[f] = f.launches - n
                f.launches = n
        for name, n in tracing.counts().items():
            if n != counts.get(name, 0):
                self.counts[name] = n - counts.get(name, 0)
        for name, n in self.counts.items():
            tracing.count(name, -n)
        self.graph = graph
        return out

    def _replay(self):
        with tracing.span(self.replay_span):
            self.graph.replay()
        for f, n in self.launches.items():
            f.launches += n
        for name, n in self.counts.items():
            tracing.count(name, n)
        tracing.count(self.counter, 1)
        return self.out

    def __call__(self, owner, *values):
        """fn(owner, *values) through the graph, the values (ints or 0-dim
        integer tensors) written into the static inputs. Returns the
        call's outputs: the warm-up's at the first call, the graph's static
        outputs (valid until the next call) after it."""
        with torch.cuda.device(self.device):
            for t, v in zip(self.inputs, values):
                t.fill_(v)
            if self.graph is None:
                return self._warm_up_and_capture(owner)
            return self._replay()
