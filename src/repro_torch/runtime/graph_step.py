"""One bucket's decode tick: eager on the CPU, one CUDA graph on the card.

``PlanServer._build_step`` is where the reference calls ``jax.jit``; the
counterpart of a jitted decode step on the card is a captured CUDA graph,
one replay in place of the several thousand kernel launches a tick issues
from Python. :func:`build_decode_step` returns, for a decode plan's step
function (``serve_loop.make_decode_step``):

- on a CPU device, :class:`EagerDecodeStep`: every tick runs the model's
  decode step eagerly;
- on a CUDA device, :class:`GraphDecodeStep`: the first tick on an arena is
  run eagerly (it is the request's real step 0, and it builds and loads the
  kernels, makes their shared-memory opt-ins and creates the cuBLAS
  workspace of the capture stream), then the tick is captured as one graph
  on that arena; every later tick on the arena replays it.

A tick is ``model.decode_step`` on static buffers — tokens ``(B, 1)``,
positions ``(B,)``, the arena's cache and its page table, all at fixed
addresses — then the greedy token and the next position written in place
into the token and position buffers. A caller copies each emitted token out
of the token buffer before the next tick.

There is no fallback: a capture or a replay that fails raises, and once a
graph exists for (step, arena) every tick on that arena replays it.

Launch counts: a capture runs the kernel wrappers without launching
anything, and a replay launches without running them. Each graph records
what its capture added to the ``launches`` of every wrapper registered in
``kernels._build.COUNTED``, takes it back off, and adds it again on every
replay, so the counts stay what an eager run would give.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels._build import COUNTED


def tick(step_fn, params, cache, tables, toks: torch.Tensor,
         pos: torch.Tensor) -> torch.Tensor:
    """One decode tick on static buffers: the step, then the greedy token
    written into ``toks`` and ``pos`` advanced by one, in place. ``tables``
    is the arena's page table (None for an arena without one). Returns the
    step's logits."""
    if tables is None:
        logits, _ = step_fn(params, cache, toks, pos)
    else:
        logits, _ = step_fn(params, cache, toks, pos, tables)
    toks.copy_(torch.argmax(logits[:, -1:], dim=-1))
    pos.add_(1)
    return logits


def _buffers(arena) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = arena.device
    return (torch.ones((arena.batch, 1), dtype=torch.int32, device=dev),
            torch.zeros((arena.batch,), dtype=torch.int32, device=dev))


class EagerDecodeStep:
    """The plain decode tick (CPU devices): each call runs the step."""

    capture_seconds = 0.0
    graphs = 0

    def __init__(self, step_fn):
        self.step_fn = step_fn

    def buffers(self, arena) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fresh token and position buffers for a request on ``arena``."""
        return _buffers(arena)

    def __call__(self, params, arena, toks, pos) -> torch.Tensor:
        return tick(self.step_fn, params, arena.cache, arena.tables, toks, pos)

    def drop(self, arena) -> None:
        pass

    def clear(self) -> None:
        pass


@dataclass
class _Graph:
    """One arena's static buffers and, once captured, its graph."""

    toks: torch.Tensor
    pos: torch.Tensor
    graph: Optional[torch.cuda.CUDAGraph] = None
    logits: Optional[torch.Tensor] = None     # the graph's static output
    params: Optional[dict] = None             # the weights it was captured with
    launches: Dict[Callable, int] = field(default_factory=dict)


class GraphDecodeStep:
    """The decode tick as one CUDA graph per arena (CUDA devices).

    Graphs are keyed by arena: arenas are recycled across requests, and a
    graph bakes in the addresses of the arena's cache and page table. The
    server drops an arena's graph when the pool evicts the arena (``drop``)
    and every graph when its weights are replaced (``clear``); a graph also
    holds the weights it was captured with and is captured again if called
    with others."""

    def __init__(self, step_fn, device: torch.device):
        self.step_fn = step_fn
        self.device = device
        self._graphs: Dict[object, _Graph] = {}
        self._stream: Optional[torch.cuda.Stream] = None
        self.capture_seconds = 0.0     # time spent capturing, summed

    @property
    def graphs(self) -> int:
        """Captured graphs held (one per arena ticked on)."""
        return sum(g.graph is not None for g in self._graphs.values())

    def buffers(self, arena) -> Tuple[torch.Tensor, torch.Tensor]:
        """The arena's static token and position buffers (the graph's
        inputs); the caller writes each request's start state into them."""
        g = self._graphs.get(arena)
        if g is None:
            g = self._graphs[arena] = _Graph(*_buffers(arena))
        return g.toks, g.pos

    def __call__(self, params, arena, toks, pos) -> torch.Tensor:
        g = self._graphs.get(arena)
        if g is None or toks is not g.toks or pos is not g.pos:
            raise ValueError("a graphed decode step ticks on the buffers that "
                             "buffers(arena) returned for this arena")
        # bring the device page table up to date before the replay reads it
        tables = arena.tables
        if g.graph is None or g.params is not params:
            return self._warm_up_and_capture(params, arena, g, tables)
        g.graph.replay()
        for fn, n in g.launches.items():
            fn.launches += n
        return g.logits

    def _warm_up_and_capture(self, params, arena, g: _Graph, tables) -> torch.Tensor:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        side, cur = self._stream, torch.cuda.current_stream(self.device)
        # the real tick, eagerly, on the stream the capture uses
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            logits = tick(self.step_fn, params, arena.cache, tables, g.toks, g.pos)
        cur.wait_stream(side)
        logits.record_stream(cur)
        t0 = time.perf_counter()
        before = {fn: fn.launches for fn in COUNTED}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = tick(self.step_fn, params, arena.cache, tables, g.toks, g.pos)
        g.launches = {fn: fn.launches - before[fn] for fn in COUNTED
                      if fn.launches != before[fn]}
        for fn, n in g.launches.items():
            fn.launches -= n
        g.graph, g.logits, g.params = graph, out, params
        self.capture_seconds += time.perf_counter() - t0
        return logits

    def drop(self, arena) -> None:
        """Forget ``arena``'s graph and buffers (the pool evicts it)."""
        self._graphs.pop(arena, None)

    def clear(self) -> None:
        """Forget every graph (the weights were replaced)."""
        self._graphs.clear()


def build_decode_step(step_fn, device: torch.device):
    """The decode tick for ``device``: a graph on CUDA, eager elsewhere."""
    if device.type == "cuda":
        return GraphDecodeStep(step_fn, device)
    return EagerDecodeStep(step_fn)
