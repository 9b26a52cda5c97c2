"""Continuous-batching scheduler: a trace-replay adapter over
:class:`~repro_torch.runtime.engine.ServingEngine` (port of
``repro/runtime/scheduler.py``).

The engine holds the whole request lifecycle — admission, mid-decode joins,
group formation, decode ticks, token streaming, cancellation, stop
conditions. This module keeps only what is specific to offline trace
replay: feed a pre-sorted ``(arrival_s, request)`` trace into a live engine
against a virtual clock that skips idle gaps, and collect the completion
records. :class:`RequestQueue` / :class:`QueuedRequest` live in the engine
and are re-exported here.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.runtime.engine import (Clock, QueuedRequest,  # noqa: F401  (re-export)
                                        RequestQueue, ServingEngine, VirtualClock)
from repro_torch.runtime.engine_config import EngineConfig
from repro_torch.runtime.metrics import SchedulerMetrics
from repro_torch.runtime.serve_loop import PlanServer, ServeRequest


class ContinuousBatchingScheduler:
    """Replays an arrival trace through a :class:`ServingEngine`.

    ``run(arrivals)`` consumes a whole trace and returns one completion
    record per request; the tick structure (admit due arrivals → joins →
    form at most one group → one decode step per active group) lives in
    ``ServingEngine.step`` and the replay loop in ``ServingEngine.run``.
    Configuration comes from ``config`` (default: the server's)."""

    def __init__(self, server: PlanServer, *, config: Optional[EngineConfig] = None,
                 queue: Optional[RequestQueue] = None, clock: Optional[Clock] = None):
        self.engine = ServingEngine(server, config=config, queue=queue,
                                    clock=clock or VirtualClock())

    # engine views (the adapter adds no state of its own) ------------------
    @property
    def server(self) -> PlanServer:
        return self.engine.server

    @property
    def queue(self) -> RequestQueue:
        return self.engine.queue

    @property
    def metrics(self) -> SchedulerMetrics:
        return self.engine.metrics

    @property
    def join_mid_decode(self) -> bool:
        return self.engine.join_mid_decode

    @property
    def active(self):
        return self.engine.active

    @property
    def results(self) -> List[Dict[str, Any]]:
        return self.engine.results

    # ----------------------------------------------------------------------
    def run(self, arrivals: Iterable[Tuple[float, ServeRequest]],
            on_event=None) -> List[Dict[str, Any]]:
        """Serve a stream of ``(arrival_s, request)`` pairs to completion;
        one record per request, in completion order. ``on_event(ev)``: an
        optional per-:class:`~repro_torch.runtime.engine.TokenEvent`
        callback, called for every event each tick emits (streaming
        consumers, ``serve.py --cancel-after``)."""
        return self.engine.run(arrivals, on_event=on_event)

    def summary(self) -> str:
        return self.engine.summary()


def simulate_arrivals(requests: Sequence[ServeRequest], rate_per_s: float = 0.0,
                      seed: int = 0) -> List[Tuple[float, ServeRequest]]:
    """Stamp requests with Poisson-process arrival times at ``rate_per_s``
    (exponential inter-arrival gaps, seeded). ``rate_per_s <= 0`` means a
    closed burst: everything arrives at t=0 (maximal coalescing pressure)."""
    if rate_per_s <= 0:
        return [(0.0, r) for r in requests]
    rng = random.Random(seed)
    t = 0.0
    out = []
    for r in requests:
        t += rng.expovariate(rate_per_s)
        out.append((t, r))
    return out
