"""CUDA-graph replay of the mesh path tracer's passes (integrator.
MeshRenderer on a CUDA device).

A MeshRenderer pass is primary -> trace (every bounce: the pool kernels,
the tile kernel at bounce 0 or the BVH8/BVH4 walk after it, the eager
glue, shading.scatter and the state update) -> the add into the band's sums
and segments. It reads nothing back to the host and its shapes are fixed
for a renderer, so one CUDA graph holds it, and a replay costs the host one
launch where the eager pass issues a few thousand operations. The graph
runs the same kernels in the same order on the same inputs, so the sums
are the eager ones bit for bit.

PassGraph follows PyTorch's recipe: the first pass a renderer runs is the
warm-up, eager on a side stream (its result is that pass's, so nothing is
thrown away), then torch.cuda.graph captures the pass into the graph's own
memory pool. The pass index is a static 0-dim int64 tensor that is written
before each replay, so one graph serves every pass. The graph belongs to
its renderer; a new renderer (a new scene object in make_render_fn)
captures anew. The sums and segments are static too, zeroed at the start
of each band_sums; band_sums returns copies of them, so no result aliases
memory that the next replay writes.

A replayed pass runs none of the pass's Python, so its spans and counters
are kept here: each replay is one `pt.replay` span and adds what the pass's
code adds (`pt.lanes`, the lanes of every bounce) and the launches each
kernel wrapper counted while the pass was captured. The capture ran that
Python without launching anything, so what it counted is taken back.
`pt.passes` counts every pass of band_sums, `pt.graph_passes` the
replayed ones.
"""

from __future__ import annotations

import torch

from .ops.cuda import kernel_wrappers
from .utils import tracing

__all__ = ["PassGraph"]


class PassGraph:
    """One MeshRenderer pass as a CUDA graph, captured at the renderer's
    first pass on its device and replayed for every pass after it. It keeps
    no reference to the renderer, which owns it and passes itself to
    band_sums, so dropping the renderer frees the graph and its pool."""

    def __init__(self, renderer):
        self.device = renderer.lane.device
        n = renderer.lane.shape[0]
        self.lanes = n * renderer.max_bounces  # pt.lanes of one pass
        self.pass_idx = torch.zeros((), dtype=torch.int64, device=self.device)
        self.sums = torch.zeros(n, 3, dtype=torch.float32, device=self.device)
        self.segments = torch.zeros((), dtype=torch.int64, device=self.device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict = {}  # wrapper -> its launches in one pass

    def _pass(self, renderer) -> None:
        """The captured work: pass `pass_idx` added into the sums."""
        rad, segs = renderer.trace_pass(self.pass_idx)
        self.sums += rad
        self.segments += segs

    def _warm_up_and_capture(self, renderer) -> None:
        """Run pass `pass_idx` eagerly on a side stream (the warm-up: the
        kernel library's load and every first launch happen here), then
        capture it."""
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._pass(renderer)
        main.wait_stream(side)
        before = {f: f.launches for f in kernel_wrappers()}
        graph = torch.cuda.CUDAGraph()
        with tracing.span("pt.capture"), torch.cuda.graph(graph):
            self._pass(renderer)
        self.launches = {f: f.launches - n for f, n in before.items()
                         if f.launches != n}
        for f, n in before.items():
            f.launches = n
        tracing.count("pt.lanes", -self.lanes)
        self.graph = graph

    def _replay(self) -> None:
        with tracing.span("pt.replay"):
            self.graph.replay()
        tracing.count("pt.lanes", self.lanes)
        tracing.count("pt.graph_passes", 1)
        for f, n in self.launches.items():
            f.launches += n

    def band_sums(self, renderer, pass_ids, progress=None):
        """MeshRenderer.band_sums through the graph: the band's radiance
        summed over the passes `pass_ids` in their order, (lanes, 3) in
        raster order, and the segments traced (a 0-dim int64 tensor), both
        fresh tensors."""
        with torch.cuda.device(self.device):
            self.sums.zero_()
            self.segments.zero_()
            for p in pass_ids:
                self.pass_idx.fill_(p)
                if self.graph is None:
                    self._warm_up_and_capture(renderer)
                else:
                    self._replay()
                tracing.count("pt.passes", 1)
                if progress is not None:
                    progress(renderer.band_pixels)
            return self.sums.clone(), self.segments.clone()
