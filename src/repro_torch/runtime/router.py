"""EngineRouter: N ServingEngine replicas behind one EngineClient surface
(port of ``repro/runtime/router.py``, with the reference's names, placement
scores and failover semantics).

Callers still ``submit(req)`` and consume token events; the router decides
*which replica* runs the request, the way the paper's compiler decides
single-node vs. distributed execution from data and cluster
characteristics:

- **placement** (``EngineConfig.placement``): the default ``"affinity"``
  policy scores replicas lexicographically on *deterministic, discrete*
  signals — can the request join an in-flight same-bucket group right now;
  would it have to queue at all; does the replica's plan cache already
  hold the bucket (no compile on the request's critical path); then
  queued+resident rows, pool live bytes, and replica index as tie-breaks.
  Immediacy outranks plan affinity on purpose: a busy warm replica must
  not win over an idle cold one, or the fleet would queue work while a
  device sits idle. Identical traces submitted at one arrival instant
  therefore place identically. The ``"load"`` policy instead ranks by
  queue pressure and the replica's *observed* TTFT tail — wall-derived,
  so adaptive rather than deterministic.

- **per-replica device time** (:class:`~repro_torch.runtime.engine.ReplicaClock`):
  replicas co-simulated serially on one host each accrue only their own
  compute, so fleet throughput is measured in device time — N replicas
  overlap as N cards would. The clock bills only compute because each
  replica's engine waits for the device at the end of every tick
  (``sync_per_tick``, the engine's default) and of every prompt pass; the
  router builds its engines with that default. On one card the replicas'
  work does not overlap in wall time: the fleet's virtual device time says
  what N cards would give, the wall clock what this card gives.

- **drain / failover** (:meth:`EngineRouter.drain_replica`): a draining
  replica's queued *and* mid-decode requests are silently withdrawn
  (``ServingEngine.withdraw`` — no terminal events, rows and pages
  reclaimed) and resubmitted to survivors with their original arrival
  times. Replicas hold equal weights (``EngineConfig.build_client`` gives
  every replica replica 0's tensors) and greedy decode is
  group-composition-invariant in float32, so the re-decode reproduces the
  tokens already streamed; :class:`RouterHandle` dedupes by delivered count
  and the consumer sees one gapless stream. Zero accepted requests are
  lost.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from dataclasses import replace as dc_replace
from typing import (TYPE_CHECKING, Any, Deque, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

from repro_torch.analysis.sanitize import assert_router
from repro_torch.core.plan_cache import bucket_pow2
from repro_torch.runtime.engine import ReplicaClock, RequestHandle, ServingEngine, TokenEvent
from repro_torch.runtime.engine_config import EngineConfig
from repro_torch.runtime.metrics import (RouterMetrics, SchedulerMetrics,
                                         merge_scheduler_metrics, router_summary)

if TYPE_CHECKING:  # the router sits beside serve_loop in the import graph
    from repro_torch.runtime.serve_loop import PlanServer, ServeRequest


@dataclass
class _Replica:
    """One engine + its private device clock and drain flag."""

    idx: int
    server: "PlanServer"
    engine: ServingEngine
    clock: ReplicaClock
    draining: bool = False

    @property
    def load_rows(self) -> int:
        """Queued plus live resident batch rows — the placement load
        signal (discrete, deterministic)."""
        eng = self.engine
        return (sum(qr.req.batch for qr in eng.queue.pending)
                + sum(m.req.batch for g in eng.active for m in g.members if not m.done))


@dataclass(frozen=True)
class PlacementDecision:
    """Audit record of one routing choice: which replica won and which
    score component decided it ("join" — fit an in-flight group;
    "idle" — serves immediately; "warm" — plan cache held the bucket;
    "load" — least-loaded fallback; "failover" — moved off a draining
    replica; "rebalance" — stolen by an idle replica)."""

    rid: int
    replica: int
    reason: str
    t: float


class RouterHandle:
    """Fleet-level request handle: same shape as
    :class:`~repro_torch.runtime.engine.RequestHandle`, but stable across
    failover. ``delivered`` counts token events forwarded to consumers —
    after a resubmission the new replica re-emits indices from 0, and the
    handle forwards only what was not already streamed, so one request is
    always one gapless token stream."""

    def __init__(self, router: "EngineRouter", req: "ServeRequest"):
        self._router = router
        self.req = req
        self.inner: Optional[RequestHandle] = None
        self.replica: Optional[_Replica] = None
        self.delivered = 0
        self.resubmits = 0
        self._events: Deque[TokenEvent] = deque()

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def qr(self):
        return self.inner.qr

    @property
    def result(self):
        return self.inner.result

    @property
    def done(self) -> bool:
        return self.inner.done

    @property
    def state(self) -> str:
        return self.inner.state

    def tokens(self):
        return self.inner.tokens()

    def stream(self) -> Iterator[TokenEvent]:
        return self._router.stream(self)

    def cancel(self) -> bool:
        return self._router.cancel(self)

    def __repr__(self) -> str:
        return (f"RouterHandle(rid={self.rid}, state={self.state!r}, "
                f"replica={self.replica.idx if self.replica else None})")


class EngineRouter:
    """N :class:`ServingEngine` replicas behind the one ``EngineClient``
    lifecycle — ``submit``/``step``/``events``/``stream``/``cancel``/
    ``drain``/``run`` — plus :meth:`drain_replica` for failover.

    ``servers`` are one :class:`PlanServer` per replica (distinct pools,
    plan caches and decode graphs; equal weights, so failover re-decodes
    reproduce the streamed tokens)."""

    def __init__(self, servers: Sequence["PlanServer"], *,
                 config: Optional[EngineConfig] = None):
        servers = list(servers)
        if not servers:
            raise ValueError("EngineRouter needs at least one server")
        cfg = config if config is not None else servers[0].config
        if cfg.replicas != len(servers):
            cfg = dc_replace(cfg, replicas=len(servers))
        self.config = cfg
        self.replicas: List[_Replica] = []
        for i, srv in enumerate(servers):
            clock = ReplicaClock()
            eng = ServingEngine(srv, config=cfg, clock=clock)
            self.replicas.append(_Replica(i, srv, eng, clock))
        self.handles: Dict[int, RouterHandle] = {}
        self.results: List[Dict[str, Any]] = []
        self.decisions: List[PlacementDecision] = []
        self.router_metrics = RouterMetrics()
        # same bounded-buffer semantics as the engine's event stream
        self._events: Deque[TokenEvent] = deque(maxlen=8192)

    # -- lifecycle API -----------------------------------------------------
    @property
    def idle(self) -> bool:
        return all(r.engine.idle for r in self.replicas)

    @property
    def metrics(self) -> SchedulerMetrics:
        """Fleet rollup of every replica's scheduler metrics (merged
        latency distributions, summed counters)."""
        return merge_scheduler_metrics([r.engine.metrics for r in self.replicas])

    def now(self) -> float:
        """Fleet virtual time: the most-advanced replica clock."""
        return max(r.clock.now() for r in self.replicas)

    def submit(self, req: "ServeRequest", arrival_s: Optional[float] = None) -> RouterHandle:
        """Place a request on one replica (see the module docstring for the
        policy) and return its fleet-level handle."""
        if req.rid in self.handles:
            raise ValueError(f"request rid={req.rid} is already in flight in this router; "
                             f"construct a new ServeRequest to resubmit")
        now = arrival_s if arrival_s is not None else self.now()
        handle = RouterHandle(self, req)
        self.handles[req.rid] = handle
        self._place(handle, now)
        return handle

    def step(self) -> List[TokenEvent]:
        """One fleet tick: rebalance queued work onto idle replicas, then
        step every busy replica once, laggard-first (keeps the per-replica
        clocks loosely synchronized), each inside its own clock's
        resume/pause window. Returns the forwarded events."""
        self._rebalance()
        out: List[TokenEvent] = []
        busy = [r for r in self.replicas if not r.engine.idle]
        for r in sorted(busy, key=lambda r: (r.clock.now(), r.idx)):
            out.extend(self._step_replica(r))
        self._sanitize()
        return out

    def _sanitize(self) -> None:
        """Fleet-level sanitizer hook (``EngineConfig(sanitize=True)``):
        every replica's pool/handle invariants plus router-level placement
        and delivery bookkeeping, re-derived from scratch each tick."""
        if self.config.sanitize:
            assert_router(self)

    def _rebalance(self) -> None:
        """Work stealing: placement is one-shot, so a replica that
        finishes early could otherwise sit idle while another's queue is
        backlogged. Each idle replica steals the oldest queued request from
        the most-backlogged donor (one per tick; followers migrate on
        subsequent ticks if the imbalance persists)."""
        for r in self.replicas:
            if r.draining or not r.engine.idle:
                continue
            donors = [d for d in self.replicas if d is not r and len(d.engine.queue)]
            if not donors:
                continue
            donor = max(donors, key=lambda d: (len(d.engine.queue), -d.idx))
            qr = donor.engine.queue.pending[0]
            handle = self.handles.get(qr.rid)
            if handle is None:
                continue
            wqr = donor.engine.withdraw(handle.inner)
            if wqr is None:
                continue
            self._place(handle, wqr.arrival_s, reason="rebalance", target=r)

    def events(self) -> Iterator[TokenEvent]:
        while True:
            while self._events:
                yield self._events.popleft()
            if self.idle:
                return
            self.step()

    def stream(self, handle: RouterHandle) -> Iterator[TokenEvent]:
        while True:
            while handle._events:
                ev = handle._events.popleft()
                yield ev
                if ev.done:
                    return
            if handle.done or self.idle:
                return
            self.step()

    def cancel(self, handle: RouterHandle) -> bool:
        if handle.done:
            return False
        ok = handle.replica.engine.cancel(handle.inner)
        if ok:
            # the engine pushed the terminal event outside a tick; forward
            # it (delivered-count dedupe makes replayed tokens no-ops)
            while handle.inner._events:
                self._forward(handle.inner._events.popleft())
        return ok

    def drain(self) -> List[Dict[str, Any]]:
        while not self.idle:
            self.step()
        return self.results

    def run(self, arrivals: Iterable[Tuple[float, "ServeRequest"]],
            on_event=None) -> List[Dict[str, Any]]:
        """Co-simulated trace replay over the fleet. Between arrivals, the
        replica whose device clock lags furthest behind steps next —
        replicas process *concurrently in virtual time* while the host
        interleaves them serially — and each arrival is placed when every
        busy replica has reached its arrival instant, so placement sees the
        fleet state of that moment. The clocks are wall-derived, so which
        replica a request lands on can differ between runs."""
        todo = sorted(arrivals, key=lambda a: a[0])
        idx = 0
        while idx < len(todo) or not self.idle:
            self._rebalance()
            t_next = todo[idx][0] if idx < len(todo) else math.inf
            busy = [r for r in self.replicas if not r.engine.idle and r.clock.now() < t_next]
            if busy:
                lag = min(busy, key=lambda r: (r.clock.now(), r.idx))
                for ev in self._step_replica(lag):
                    if on_event is not None:
                        on_event(ev)
                continue
            t, req = todo[idx]
            idx += 1
            self.submit(req, arrival_s=t)
        return self.results

    # -- failover ----------------------------------------------------------
    def drain_replica(self, idx: int) -> List[RouterHandle]:
        """Take replica ``idx`` out of rotation and move its live work to
        the survivors: queued and mid-decode requests are silently
        withdrawn (rows and pages reclaimed, no terminal events) and
        resubmitted with their *original* arrival times, so queueing
        latency includes the disruption. Returns the moved handles; zero
        accepted requests are lost. The replica's arenas and decode graphs
        stay with its pool."""
        r = self.replicas[idx]
        if r.draining:
            return []
        if not [x for x in self.replicas if not x.draining and x is not r]:
            raise ValueError("cannot drain the last live replica")
        r.draining = True
        self.router_metrics.failovers += 1
        self.router_metrics.drained += 1
        moved: List[RouterHandle] = []
        victims = [h for h in self.handles.values() if h.replica is r and not h.done]
        for h in victims:
            qr = r.engine.withdraw(h.inner)
            if qr is None:
                continue
            self._place(h, qr.arrival_s, failover=True)
            h.resubmits += 1
            self.router_metrics.resubmitted += 1
            moved.append(h)
        self._sanitize()
        return moved

    def restore_replica(self, idx: int) -> None:
        """Put a drained replica back into placement rotation."""
        r = self.replicas[idx]
        if r.draining:
            r.draining = False
            self.router_metrics.drained -= 1

    # -- placement ---------------------------------------------------------
    def _place(self, handle: RouterHandle, arrival_s: float, failover: bool = False,
               reason: Optional[str] = None, target: Optional[_Replica] = None) -> None:
        req = handle.req
        if target is not None:
            best = target
        else:
            candidates = [r for r in self.replicas if not r.draining]
            if not candidates:
                raise RuntimeError("every replica is draining")
            score, best = min(((self._score(r, req), r) for r in candidates),
                              key=lambda sr: sr[0])
            if reason is None:
                reason = ("failover" if failover else
                          "join" if score[0] == 0 else
                          "idle" if score[1] == 0 else
                          "warm" if score[2] == 0 else "load")
        if best.engine.idle:
            # the device sat idle until this arrival: skip its clock
            # forward like any idle engine would (never rewinds)
            best.clock.advance_to(arrival_s)
        handle.inner = best.engine.submit(req, arrival_s=arrival_s)
        handle.replica = best
        self.decisions.append(PlacementDecision(req.rid, best.idx, reason, arrival_s))
        self.router_metrics.observe_placement(reason)

    def _score(self, r: _Replica, req: "ServeRequest") -> Tuple:
        """Lexicographic placement score — smaller wins. Order matters:
        immediacy (join / no-queue) outranks plan warmth, which outranks
        load; a busy warm replica must never beat an idle cold one, or the
        router would queue work while a device idles."""
        eng, srv = r.engine, r.server
        sb = eng.queue.seq_bucket(req)
        # rows already spoken for by queued same-bucket work: a joiner
        # only truly fits if capacity remains after the earlier queue
        # would be seated (conservative, keeps placement FIFO-honest)
        queued_rows = sum(qr.req.batch for qr in eng.queue.pending
                          if eng.queue.seq_bucket(qr.req) == sb)
        can_join = False
        if eng.join_mid_decode:
            for g in eng.active:
                if g.seq_bucket != sb:
                    continue
                if g.arena.rows_free - queued_rows < req.batch:
                    continue
                if self._join_fits(srv, g.arena, req):
                    can_join = True
                    break
        span = srv.request_span(req)
        demand = srv.pool.member_bytes(sb, req.batch, span) if srv.pool.paged else None
        bb = bucket_pow2(req.batch, srv.policy.min_batch)
        # an idle engine can always force a lease; otherwise ask the pool
        can_form = (not eng.active) or srv.pool.can_acquire(bb, sb, demand_bytes=demand)
        # "immediate" means a join (shares the group's decode step — free
        # capacity) or an idle engine; a busy engine that can merely lease
        # another arena still contends for the device, so the request
        # effectively queues behind the in-flight work
        would_queue = (not can_join) and (len(eng.queue) > 0 or bool(eng.active)
                                          or not can_form)
        if self.config.placement == "load":
            # adaptive: queue pressure, then the replica's observed TTFT
            # tail (wall-derived — deliberately not deterministic)
            return (1 if would_queue else 0, r.load_rows,
                    eng.metrics.ttft_latency.percentile(95), srv.pool.live_bytes(), r.idx)
        has_plan = any(k.kind == "decode" and k.seq_bucket == sb for k in srv.cache.keys())
        return (0 if can_join else 1, 1 if would_queue else 0, 0 if has_plan else 1,
                r.load_rows, srv.pool.live_bytes(), r.idx)

    @staticmethod
    def _join_fits(srv: "PlanServer", arena, req: "ServeRequest") -> bool:
        """Mirror of the engine's paged join predicate: free rows are not
        enough, the request's pages and bytes must fit too."""
        if not srv.pool.paged:
            return True
        span = srv.request_span(req)
        pages = arena.span_pages(span) * req.batch
        if arena.n_pages and pages > arena.allocator.available:
            return False
        return srv.pool.member_bytes(arena.seq, req.batch, span) <= srv.pool.bytes_room()

    # -- event plumbing ----------------------------------------------------
    def _step_replica(self, r: _Replica) -> List[TokenEvent]:
        r.clock.resume()
        try:
            tick = r.engine.step()
        finally:
            r.clock.pause()
        out = []
        for ev in tick:
            fwd = self._forward(ev)
            if fwd is not None:
                out.append(fwd)
        return out

    def _forward(self, ev: TokenEvent) -> Optional[TokenEvent]:
        """Dedupe + re-index one replica event into the fleet stream.
        Token events below the handle's delivered count are failover
        replays (already streamed) and are dropped; terminal events
        finalize the handle and append its record in fleet completion
        order."""
        handle = self.handles.get(ev.rid)
        if handle is None:
            return None
        if ev.token is not None:
            if ev.index < handle.delivered:
                return None
            fwd = ev if ev.index == handle.delivered else dc_replace(ev, index=handle.delivered)
            handle.delivered += 1
        elif ev.done:
            fwd = ev if ev.index == handle.delivered else dc_replace(ev, index=handle.delivered)
            self.results.append(handle.inner.result)
            self.handles.pop(ev.rid, None)
        else:
            return None
        self._events.append(fwd)
        handle._events.append(fwd)
        return fwd

    # -- reporting ---------------------------------------------------------
    def summary(self) -> str:
        return router_summary(self)
