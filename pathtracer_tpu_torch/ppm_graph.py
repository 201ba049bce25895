"""CUDA-graph replay of the photon mapper's iterations (ppm.PPMRenderer on
one CUDA device, with no process group).

An iteration's prefix, _Passes.prefix, is the photon pass (emission, the
sampler and max_bounces bounces of the composite intersector), the photon
map's length, gather_kernel.build_photon_chunks over the deposits, and each
band's eye walk (the tile kernel or the walk) with its eye-hit sum. It
reads nothing back to the host and its shapes are fixed for a renderer, so
one CUDA graph holds it, and a replay costs the host one launch where the
eager prefix issues a few thousand operations. The chunk gather that
follows reads its item count on the host, so it stays eager, with the hit
sort, finish and the film; it runs on the same stream, so it reads the
graph's outputs before the next replay writes them. The graph runs the
same kernels in the same order on the same inputs, so the image is the
eager one bit for bit.

IterGraph follows mesh_graph.PassGraph: the renderer's first iteration is
the warm-up, eager on a side stream (its result is that iteration's, so
nothing is thrown away), then torch.cuda.graph captures the prefix into
the graph's own memory pool. The photon offset and the eye offset are
static 0-dim int64 tensors written before each replay, so one graph serves
every iteration of every later render. The renderer keeps the graph, with
the passes it was captured from, until a field that sets its shapes or
constants changes.

A replay runs none of the prefix's Python, so what that Python counts is
kept here: each replay is one `ppm.replay` span, adds the launches each
kernel wrapper counted while the prefix was captured (the capture ran that
Python without launching anything, so what it counted is taken back) and
counts `ppm.graph_iters`. The outputs that the renderer keeps past the
iteration (the map length, the segments and the eye hits, 0-dim tensors)
are returned as copies, so no kept result aliases memory that the next
replay writes.
"""

from __future__ import annotations

import torch

from .ops.cuda import kernel_wrappers
from .utils import tracing

__all__ = ["IterGraph"]


def _fresh(out):
    """The prefix's outputs with each 0-dim tensor copied."""
    if isinstance(out, torch.Tensor):
        return out.clone() if out.dim() == 0 else out
    return type(out)(_fresh(x) for x in out)


class IterGraph:
    """The prefix of a PPMRenderer's iteration as a CUDA graph, captured at
    the first iteration it runs and replayed for every iteration after it.
    `key` is the renderer's record of the fields the graph was captured
    under, `passes` the ppm._Passes it runs."""

    def __init__(self, key, passes, device):
        self.key, self.passes, self.device = key, passes, device
        self.photon_offset = torch.zeros((), dtype=torch.int64, device=device)
        self.eye_offset = torch.zeros((), dtype=torch.int64, device=device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out = None  # the captured prefix's outputs
        self.launches: dict = {}  # wrapper -> its launches in one prefix

    def _prefix(self):
        return self.passes.prefix(self.photon_offset, self.eye_offset)

    def _warm_up_and_capture(self):
        """Run the prefix eagerly on a side stream (the warm-up: the kernel
        library's load and every first launch happen here) and return its
        outputs, then capture it."""
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._prefix()
        main.wait_stream(side)
        before = {f: f.launches for f in kernel_wrappers()}
        graph = torch.cuda.CUDAGraph()
        with tracing.span("ppm.capture"), torch.cuda.graph(graph):
            self.out = self._prefix()
        self.launches = {f: f.launches - n for f, n in before.items()
                         if f.launches != n}
        for f, n in before.items():
            f.launches = n
        self.graph = graph
        return out

    def _replay(self):
        with tracing.span("ppm.replay"):
            self.graph.replay()
        tracing.count("ppm.graph_iters", 1)
        for f, n in self.launches.items():
            f.launches += n
        return self.out

    def run(self, photon_offset: int, eye_offset: int):
        """_Passes.prefix(photon_offset, eye_offset) through the graph:
        (photon segments, map length, grid, walks), the 0-dim tensors
        fresh, the rest the graph's static outputs (valid until the next
        run)."""
        with torch.cuda.device(self.device):
            self.photon_offset.fill_(photon_offset)
            self.eye_offset.fill_(eye_offset)
            out = (self._warm_up_and_capture() if self.graph is None
                   else self._replay())
            return _fresh(out)
