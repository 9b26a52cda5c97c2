"""ServingEngine: the single request-lifecycle API for the serving path (port
of ``repro/runtime/engine.py``).

One entry point whose internals pick the execution strategy:
``PlanServer.handle`` (one request, submit and drain) and
``ContinuousBatchingScheduler.run`` (a whole arrival trace) are thin
adapters over this class, so the admission sequence, the decode tick and
the stop conditions exist once.

The engine is re-entrant and tick-driven:

- :meth:`ServingEngine.submit` admits a request into a live engine at any
  time and returns a :class:`RequestHandle`;
- :meth:`ServingEngine.step` advances every active group by one decode
  tick, in the phases ``joins -> form -> tick``;
- :meth:`ServingEngine.stream` / :meth:`ServingEngine.events` yield
  :class:`TokenEvent`\\ s as tokens are produced;
- :meth:`ServingEngine.cancel` and per-request stop conditions
  (``ServeRequest.eos_id`` / ``ServeRequest.stop``) end a row early — its
  cache rows, committed pages and undrawn span reservation are released the
  same tick, so early exits become mid-decode join capacity at once.

Time is injectable (:class:`Clock`): :class:`VirtualClock` skips idle gaps
for simulated traces, :class:`WallClock` serves online traffic,
:class:`ReplicaClock` accrues only the compute between its
``resume``/``pause`` calls (per-replica device time for a co-simulated
fleet).

What differs from the reference, all of it forced by the decode tick being
one CUDA graph per (entry, arena) on the card (``runtime.graph_step``):

- a group's token and position tensors are the step's static buffers
  (``step.buffers(arena)``); the step writes the greedy token and the next
  position into them in place, and joiners' rows are written into the same
  tensors by indexed copies outside the graph, never by rebinding them;
- each member's tokens are gathered out of the token buffer (a copy) right
  after the tick that produced them, before the next replay overwrites it;
- the step updates the arena's cache in place, so there is no
  relinquish/adopt around it and no double-buffered cache to charge (the
  reference's donating path);
- the step's capture time is billed to the plan cache's
  ``compile_seconds``, and a completion record carries ``last_logits``, the
  request rows' logits of the pass that produced its last token.

One addition: :meth:`ServingEngine.admit` runs a tick's admission half
alone, so that ``PlanServer.handle`` can name its request's prompt pass and
its decode as two profiler spans.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Any, Deque, Dict, Iterable, Iterator, List, Optional,
                    Protocol, Sequence, Tuple, runtime_checkable)

import numpy as np
import torch

from repro_torch.analysis.sanitize import assert_engine
from repro_torch.config import InputShape
from repro_torch.core.plan_cache import BucketPolicy, CacheEntry, bucket_pow2
from repro_torch.runtime.engine_config import EngineConfig
from repro_torch.runtime.kv_cache import CacheArena
from repro_torch.runtime.metrics import SchedulerMetrics, scheduler_summary

if TYPE_CHECKING:  # the engine sits below serve_loop in the import graph
    from repro_torch.runtime.serve_loop import PlanServer, ServeRequest

# names of the serving phases as torch.profiler spans: every prompt pass of
# an admission, and (opened by PlanServer.handle) a request's whole decode
PREFILL_SPAN = "PlanServer.prefill"
DECODE_SPAN = "PlanServer.decode"


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ===========================================================================
# clocks
# ===========================================================================


class Clock(Protocol):
    """Injectable time source for the tick loop. ``now`` is seconds since
    the clock's epoch; ``advance_to`` is called when the engine is idle and
    knows when the next arrival is due."""

    def now(self) -> float: ...

    def advance_to(self, t: float) -> None: ...


class VirtualClock:
    """Virtual clock: real elapsed time plus skipped idle gaps. Never runs
    slower than the wall — execution is measured, idle time is skipped —
    so simulated arrival traces replay at full speed."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._skew = 0.0

    def now(self) -> float:
        return time.perf_counter() - self._t0 + self._skew

    def advance_to(self, t: float) -> None:
        self._skew += max(0.0, t - self.now())


class WallClock:
    """Real time for online traffic: idle gaps are waited out, not skipped
    (``advance_to`` sleeps until the target instant)."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def advance_to(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


class ReplicaClock:
    """Per-replica virtual device time for co-simulated fleets.

    Real ``perf_counter`` deltas accrue only between :meth:`resume` and
    :meth:`pause` — the window a router holds open around *this* replica's
    ``engine.step()`` — and idle gaps skip forward like
    :class:`VirtualClock`, so N replicas interleaved on one host each
    observe only their own compute."""

    def __init__(self):
        self._t = 0.0
        self._anchor: Optional[float] = None   # perf_counter at resume

    @property
    def running(self) -> bool:
        return self._anchor is not None

    def now(self) -> float:
        if self._anchor is not None:
            return self._t + (time.perf_counter() - self._anchor)
        return self._t

    def advance_to(self, t: float) -> None:
        if t > self.now():
            self._t = t
            if self._anchor is not None:
                self._anchor = time.perf_counter()

    def resume(self) -> None:
        if self._anchor is None:
            self._anchor = time.perf_counter()

    def pause(self) -> None:
        if self._anchor is not None:
            self._t += time.perf_counter() - self._anchor
            self._anchor = None


# ===========================================================================
# queue
# ===========================================================================


@dataclass
class QueuedRequest:
    """One admitted request plus its lifecycle timestamps (engine clock).
    ``rid`` is the request's own construction-stamped id — handles,
    scheduler results, and metrics all key on the same value."""

    rid: int
    req: "ServeRequest"
    arrival_s: float
    start_s: float = -1.0        # prefill began (group start or mid-decode join)
    finish_s: float = -1.0       # last requested token decoded

    @property
    def queue_s(self) -> float:
        return max(0.0, self.start_s - self.arrival_s)

    @property
    def exec_s(self) -> float:
        return max(0.0, self.finish_s - self.start_s)

    @property
    def total_s(self) -> float:
        return max(0.0, self.finish_s - self.arrival_s)


class RequestQueue:
    """FIFO admission with bucket-aware coalescing.

    Buckets are over ``context + new_tokens`` — the whole cache span a
    request occupies — so a context landing exactly on a power-of-two
    boundary still gets rows for every token it will generate.

    ``next_group`` is head-of-line fair by default (``select="hol"``): the
    *oldest* pending request picks the bucket, and only same-bucket
    requests may join its group (in arrival order, until the group's batch
    capacity is full). A popular bucket can therefore never starve an
    unpopular one.

    ``select="arrival"`` is arrival-aware: the pending bucket with the
    most coalescable rows (ties broken toward the older bucket) forms
    first. The trade of fairness for fuller groups is bounded by
    ``max_defer``: after the head-of-line request's bucket has been passed
    over that many consecutive times, it forms next regardless.
    """

    def __init__(self, policy: BucketPolicy = BucketPolicy(),
                 max_group_batch: int = 8, select: str = "hol",
                 max_defer: int = 4):
        if max_group_batch < 1:
            raise ValueError("max_group_batch must be >= 1")
        if select not in ("hol", "arrival"):
            raise ValueError(f"select must be hol|arrival, got {select!r}")
        self.policy = policy
        self.max_group_batch = max_group_batch
        self.select = select
        self.max_defer = max(1, max_defer)
        self._deferrals = 0          # consecutive head-bucket pass-overs
        self._pending: List[QueuedRequest] = []

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def pending(self) -> Tuple[QueuedRequest, ...]:
        return tuple(self._pending)

    def seq_bucket(self, req: "ServeRequest") -> int:
        return bucket_pow2(req.context + req.new_tokens, self.policy.min_seq)

    def admit(self, req: "ServeRequest", arrival_s: float = 0.0) -> QueuedRequest:
        qr = QueuedRequest(rid=req.rid, req=req, arrival_s=arrival_s)
        self._pending.append(qr)
        return qr

    def remove(self, rid: int) -> Optional[QueuedRequest]:
        """Pull a still-pending request out of the queue (cancellation
        before admission); None if ``rid`` is not pending."""
        for qr in self._pending:
            if qr.rid == rid:
                self._pending.remove(qr)
                return qr
        return None

    def _select_bucket(self) -> int:
        """Pick the bucket the next group serves. "hol": the oldest pending
        request's bucket, unconditionally. "arrival": the bucket with the
        most immediately-coalescable rows (capped at the group capacity),
        ties broken toward the bucket with the oldest arrival; the
        head-of-line bucket is forced through after ``max_defer``
        consecutive deferrals."""
        head_sb = self.seq_bucket(self._pending[0].req)
        if self.select != "arrival" or len(self._pending) == 1:
            self._deferrals = 0
            return head_sb
        if self._deferrals >= self.max_defer:
            self._deferrals = 0
            return head_sb
        rows: Dict[int, int] = {}
        oldest: Dict[int, int] = {}          # bucket -> first pending index
        for i, qr in enumerate(self._pending):
            sb = self.seq_bucket(qr.req)
            rows[sb] = min(self.max_group_batch, rows.get(sb, 0) + qr.req.batch)
            oldest.setdefault(sb, i)
        best = max(rows, key=lambda sb: (rows[sb], -oldest[sb]))
        if best != head_sb:
            self._deferrals += 1
        else:
            self._deferrals = 0
        return best

    def next_group(self) -> List[QueuedRequest]:
        """Pop the next coalesced group (empty list if nothing pending).

        The selected bucket's oldest request always joins (even if its
        batch alone exceeds ``max_group_batch`` — it must be served
        eventually); later same-bucket requests fill the remaining batch
        slots in FIFO order, skipping any too big for the space left.
        """
        if not self._pending:
            return []
        sb = self._select_bucket()
        lead = next(qr for qr in self._pending if self.seq_bucket(qr.req) == sb)
        group: List[QueuedRequest] = [lead]
        used = lead.req.batch
        for qr in self._pending:
            if qr is lead or self.seq_bucket(qr.req) != sb:
                continue
            if used + qr.req.batch > self.max_group_batch:
                continue
            group.append(qr)
            used += qr.req.batch
        for qr in group:
            self._pending.remove(qr)
        return group

    def requeue_front(self, members: Sequence[QueuedRequest]) -> None:
        """Return a popped group to the queue (the pool refused the arena
        lease), merging by *arrival order* — not wholesale at the front, so
        riders popped from deep in the queue cannot jump older requests of
        other buckets (``_pending[0]`` stays the oldest pending request)."""
        self._pending = sorted(self._pending + list(members),
                               key=lambda qr: (qr.arrival_s, qr.rid))

    def take_joinable(self, seq_bucket: int, max_rows: int,
                      fits=None) -> List[QueuedRequest]:
        """Pop pending same-bucket requests that fit in ``max_rows`` free
        arena rows, strictly FIFO *within the bucket*: scanning stops at the
        first same-bucket request that does not fit, so later narrow
        arrivals can never leapfrog a wide head of their own bucket.

        ``fits(qr)``: extra admission predicate (free cache pages, byte
        budget); it may track cumulative commitments across accepted
        candidates — it is called once per candidate, in scan order, and a
        False return stops the scan like an unfitting batch does."""
        taken: List[QueuedRequest] = []
        room = max_rows
        for qr in list(self._pending):
            if room <= 0:
                break
            if self.seq_bucket(qr.req) != seq_bucket:
                continue
            if qr.req.batch > room:
                break
            if fits is not None and not fits(qr):
                break
            taken.append(qr)
            room -= qr.req.batch
            self._pending.remove(qr)
        return taken


# ===========================================================================
# events + handles
# ===========================================================================


@dataclass(frozen=True)
class TokenEvent:
    """One per-token (or terminal) notification from the engine.

    ``token`` is the request's ``(batch, 1)`` int32 token for output
    position ``index`` (a tensor on the server's device) — or None on the
    terminal event, which instead carries ``done=True`` and the
    ``finish_reason`` ("length", "eos", "stop", or "cancelled"). ``step`` is
    the owning group's decode step at emission (0 = produced by prefill);
    ``t`` is the engine-clock time."""

    rid: int
    index: int
    token: Optional[torch.Tensor]
    t: float
    step: int
    done: bool = False
    finish_reason: Optional[str] = None


def _no_tokens(batch: int, device) -> torch.Tensor:
    return torch.zeros((batch, 0), dtype=torch.int32, device=device)


class RequestHandle:
    """A submitted request's lifecycle handle: inspect its state, stream its
    tokens, or cancel it. ``result`` is the completion record (the same dict
    that lands in ``engine.results``) once the request finished."""

    def __init__(self, engine: "ServingEngine", qr: QueuedRequest):
        self._engine = engine
        self.qr = qr
        # queued | active | done | cancelled | withdrawn (router failover)
        self.state = "queued"
        self.result: Optional[Dict[str, Any]] = None
        self._events: Deque[TokenEvent] = deque()

    @property
    def rid(self) -> int:
        return self.qr.rid

    @property
    def req(self) -> "ServeRequest":
        return self.qr.req

    @property
    def done(self) -> bool:
        return self.result is not None

    def tokens(self) -> torch.Tensor:
        """Generated tokens so far — the full output once ``done``."""
        if self.result is not None:
            return self.result["tokens"]
        member = self._engine._member_of(self.rid)
        if member is None or not member.toks:
            return _no_tokens(self.req.batch, self._engine.server.device)
        return torch.cat(member.toks, dim=1)

    def stream(self) -> Iterator[TokenEvent]:
        return self._engine.stream(self)

    def cancel(self) -> bool:
        return self._engine.cancel(self)

    def __repr__(self) -> str:
        return f"RequestHandle(rid={self.rid}, state={self.state!r})"


# ===========================================================================
# group bookkeeping
# ===========================================================================


@dataclass
class _Member:
    """One request's tenancy inside a group: its arena rows, when it joined
    (in decode steps), and its emitted-token state."""

    qr: QueuedRequest
    rows: List[int]
    rows_t: torch.Tensor         # int64 row-index tensor on the device (cached)
    join_step: int
    base_pos: int = 0            # decode start position (prompt len / 0)
    done: bool = False
    finish_reason: Optional[str] = None
    toks: List[torch.Tensor] = field(default_factory=list)   # emitted (batch, 1)
    emitted: int = 0
    last_t: float = 0.0          # engine-clock time of the last token event
    rows_live: Optional[np.ndarray] = None          # eos/stop per-row mask
    tails: Optional[List[List[int]]] = None         # stop-sequence tails
    # the member rows' logits of the prompt pass that seeded them
    prefill_logits: Optional[torch.Tensor] = None

    @property
    def req(self) -> "ServeRequest":
        return self.qr.req


@dataclass
class _Group:
    """One decode batch in flight over a leased cache-pool arena. Rows sit
    at per-row positions, so members at different generation depths (and
    mid-decode joiners) share the one decode step. ``toks``/``pos`` are the
    step's buffers for the arena (the graph's inputs on the card)."""

    entry: CacheEntry                 # decode plan for the group's bucket
    arena: CacheArena
    context: int                      # max member span (stats naming)
    members: List[_Member]
    toks: torch.Tensor                # (batch_bucket, 1) next decode inputs
    pos: torch.Tensor                 # (batch_bucket,) int32 per-row positions
    steps_done: int = 0
    peak_rows: int = 0                # max *concurrent* leased rows observed
    logits: Optional[torch.Tensor] = None   # the last tick's logits

    @property
    def done(self) -> bool:
        return all(m.done for m in self.members)

    @property
    def seq_bucket(self) -> int:
        return self.entry.key.seq_bucket


# ===========================================================================
# the client protocol
# ===========================================================================


@runtime_checkable
class EngineClient(Protocol):
    """The serving surface callers program against — satisfied by
    :class:`ServingEngine` (one device) and
    :class:`~repro_torch.runtime.router.EngineRouter` (N replicas), so
    callers are written once and ``replicas=1`` is the bare engine.
    ``handles`` maps live request ids to their handles (event-driven
    cancellation routes through it)."""

    handles: Dict[int, Any]

    def submit(self, req: "ServeRequest", arrival_s: Optional[float] = None): ...

    def step(self) -> List[TokenEvent]: ...

    def events(self) -> Iterator[TokenEvent]: ...

    def stream(self, handle) -> Iterator[TokenEvent]: ...

    def cancel(self, handle) -> bool: ...

    def drain(self) -> List[Dict[str, Any]]: ...

    def run(self, arrivals: Iterable[Tuple[float, "ServeRequest"]],
            on_event=None) -> List[Dict[str, Any]]: ...

    def summary(self) -> str: ...

    @property
    def idle(self) -> bool: ...

    @property
    def metrics(self) -> SchedulerMetrics: ...


# ===========================================================================
# the engine
# ===========================================================================


class ServingEngine:
    """Re-entrant, tick-driven request-lifecycle engine over a
    :class:`~repro_torch.runtime.serve_loop.PlanServer`.

    Both plan families come from the server's one plan cache:
    ``kind="prefill"`` entries for the batched prompt pass, ``kind="decode"``
    entries for the shared-arena decode ticks. Per tick (:meth:`step`):
    absorb pending same-bucket requests into free rows of in-flight groups
    (mid-decode joins), form at most one new group (pool budget permitting),
    then advance every active group by one decode tick — emitting a
    :class:`TokenEvent` per live request.

    Mode flags (the adapters differ only in these):

    - ``prefill``: run the cached-prefill prompt pass at admission and seed
      decode with its first token (False: seed with token 1, the
      decode-only request shape);
    - ``count_first``: the prefill-produced token is output token #1
      (False: it only seeds decode, and a request emits exactly
      ``new_tokens`` decode outputs);
    - ``eager_pages``: commit each row's whole span at admission instead of
      growing page by page (the sequential ``handle`` adapter's shape);
    - ``sync_per_tick``: wait for the device after every decode tick so
      per-token timestamps (TTFT / inter-token latency) measure compute,
      not dispatch. False lets the ticks queue on the device — the
      sequential ``handle`` adapter's choice, which measures one end-to-end
      latency and does not stream.

    ``decode_ticks`` counts the group decode ticks run (one per active group
    per step): each one is a graph replay (or its eager first tick) on the
    card.
    """

    def __init__(self, server: "PlanServer", *, config: Optional[EngineConfig] = None,
                 queue: Optional[RequestQueue] = None, clock: Optional[Clock] = None,
                 prefill: bool = True, count_first: bool = True,
                 eager_pages: bool = False, sync_per_tick: bool = True):
        # explicit config wins, else the server's; the mode flags stay plain
        # kwargs: they are adapter modes (handle() vs scheduler), not
        # scenario configuration
        self.config = config if config is not None else server.config
        self.server = server
        self.clock: Clock = clock or VirtualClock()
        self.queue = queue or RequestQueue(server.policy, self.config.max_group_batch,
                                           select=self.config.bucket_select)
        self.metrics = SchedulerMetrics(slo_s=self.config.slo_ms / 1e3)
        self.join_mid_decode = self.config.join_mid_decode
        self.prefill = prefill
        self.count_first = count_first
        self.eager_pages = eager_pages
        self.sync_per_tick = sync_per_tick
        self.active: List[_Group] = []
        self.results: List[Dict[str, Any]] = []
        self.decode_ticks = 0
        # live requests only: entries are pruned at group retire (and on
        # queue-cancel), so a long-running engine holds handles for what is
        # in flight; user-held handles keep their own buffers and .result
        self.handles: Dict[int, RequestHandle] = {}
        # bounded: an events() consumer drains this every tick, so the cap
        # only bites when nobody consumes — then old events expire instead
        # of accumulating one device tensor per token forever
        self._events: Deque[TokenEvent] = deque(maxlen=8192)
        self._tick_sink: Optional[List[TokenEvent]] = None
        # requests already counted in pages_denied — the join predicate runs
        # every tick, and a retried candidate must not re-count as a denial
        self._page_denied_rids: set = set()

    # -- lifecycle API -----------------------------------------------------
    @property
    def idle(self) -> bool:
        """Nothing pending and nothing in flight."""
        return not len(self.queue) and not self.active

    def submit(self, req: "ServeRequest", arrival_s: Optional[float] = None) -> RequestHandle:
        """Admit a request into the live engine (any time, any order) and
        return its lifecycle handle. ``arrival_s`` defaults to the engine
        clock's now — pass explicit times when replaying a trace.

        A request can be in flight at most once per engine: ids are
        construction-stamped, and events/cancellation route by id."""
        if req.rid in self.handles:
            raise ValueError(f"request rid={req.rid} is already in flight in this "
                             f"engine; construct a new ServeRequest to resubmit")
        now = self.clock.now() if arrival_s is None else arrival_s
        qr = self.queue.admit(req, now)
        handle = RequestHandle(self, qr)
        self.handles[qr.rid] = handle
        self.metrics.admitted += 1
        return handle

    def admit(self) -> None:
        """The admission half of a tick — mid-decode joins, then at most one
        new group, each with its prompt pass — without decoding. ``step``
        runs it itself; ``PlanServer.handle`` calls it alone so that its
        request's prompt pass and decode are separate phases."""
        if self.join_mid_decode:
            for group in self.active:
                self._phase_joins(group)
        self._phase_form()
        self.metrics.observe_resident(
            sum(1 for g in self.active for m in g.members if not m.done))

    def step(self) -> List[TokenEvent]:
        """Advance the engine by one tick: mid-decode joins, at most one new
        group, then one decode step for every active group. Returns the
        events emitted during this tick."""
        self._tick_sink = []
        try:
            self.admit()
            for group in list(self.active):
                if not group.done:
                    self._phase_tick(group)
                if group.done:
                    self._retire_group(group)
                    self.active.remove(group)
            self._sanitize()
            return self._tick_sink
        finally:
            self._tick_sink = None

    def _sanitize(self) -> None:
        """Runtime sanitizer hook: under ``EngineConfig(sanitize=True)``
        cross-check pool/arena/handle invariants from scratch after every
        state transition and raise ``SanitizeError`` on the first drifted
        tick instead of serving corrupt state."""
        if self.config.sanitize:
            assert_engine(self)

    def events(self) -> Iterator[TokenEvent]:
        """Yield token events as they are produced, stepping the engine
        whenever the buffer runs dry, until it is idle. Consumes the
        engine-wide buffer (bounded: it holds events since the last drain)."""
        while True:
            while self._events:
                yield self._events.popleft()
            if self.idle:
                return
            self.step()

    def stream(self, handle: RequestHandle) -> Iterator[TokenEvent]:
        """Yield one request's token events as they are produced, stepping
        the engine as needed, until its terminal event."""
        while True:
            while handle._events:
                ev = handle._events.popleft()
                yield ev
                if ev.done:
                    return
            if handle.done or self.idle:
                return
            self.step()

    def cancel(self, handle: RequestHandle) -> bool:
        """Terminate a request now. Queued requests leave the queue with an
        empty output; active requests complete with the tokens produced so
        far, and their cache rows / committed pages / undrawn span
        reservation return to the pool the same tick. False if the request
        already finished."""
        if handle.done:
            return False
        now = self.clock.now()
        qr = self.queue.remove(handle.rid)
        if qr is not None:
            qr.start_s = qr.finish_s = now
            self.metrics.cancelled += 1
            self._finish_record(
                handle, rid=qr.rid, batch=qr.req.batch, context=qr.req.context,
                bucket=None, group_size=0, joined_at_step=-1,
                tokens=_no_tokens(qr.req.batch, self.server.device),
                queue_s=qr.queue_s, exec_s=0.0, total_s=qr.total_s,
                finish_reason="cancelled")
            self._push(TokenEvent(rid=qr.rid, index=0, token=None, t=now, step=0,
                                  done=True, finish_reason="cancelled"))
            self.handles.pop(qr.rid, None)
            self._sanitize()
            return True
        for group in self.active:
            for m in group.members:
                if m.qr.rid == handle.rid and not m.done:
                    self._complete(m, group, now, "cancelled")
                    self._sanitize()
                    return True
        return False

    def drain(self) -> List[Dict[str, Any]]:
        """Step until idle; returns the accumulated completion records."""
        while not self.idle:
            self.step()
        return self.results

    def run(self, arrivals: Iterable[Tuple[float, "ServeRequest"]],
            on_event=None) -> List[Dict[str, Any]]:
        """Replay a ``(arrival_s, request)`` trace to completion.

        Arrivals are submitted when due on the engine clock; between
        arrivals the engine ticks, and an idle engine skips ahead to the
        next arrival (a virtual clock) instead of waiting. ``on_event(ev)``
        is called for every event each tick emits — the hook streaming
        consumers and cancellation hooks use."""
        todo = sorted(arrivals, key=lambda a: a[0])
        idx = 0
        while idx < len(todo) or not self.idle:
            now = self.clock.now()
            while idx < len(todo) and todo[idx][0] <= now:
                self.submit(todo[idx][1], arrival_s=todo[idx][0])
                idx += 1
            if self.idle:
                self.clock.advance_to(todo[idx][0])
                continue
            events = self.step()
            if on_event is not None:
                for ev in events:
                    on_event(ev)
        return self.results

    def withdraw(self, handle: RequestHandle) -> Optional[QueuedRequest]:
        """Silently remove a live request for resubmission elsewhere (a
        router's failover primitive). Unlike :meth:`cancel` this emits no
        terminal event and writes no completion record, and the admission
        count is given back. An active member's rows, committed pages and
        undrawn span reservation return to the pool immediately. Returns
        the queue record; None if the request already finished."""
        if handle.done:
            return None
        qr = self.queue.remove(handle.rid)
        if qr is None:
            for group in list(self.active):
                for m in group.members:
                    if m.qr.rid == handle.rid and not m.done:
                        m.done = True
                        m.finish_reason = "withdrawn"
                        self.server.pool.free_rows(group.arena, m.rows, early=True)
                        if group.done:
                            self._retire_group(group)
                            self.active.remove(group)
                        qr = m.qr
                        break
                if qr is not None:
                    break
        if qr is None:
            return None
        self.metrics.admitted -= 1
        self.handles.pop(handle.rid, None)
        self._page_denied_rids.discard(handle.rid)
        handle.state = "withdrawn"
        handle._events.clear()
        self._sanitize()
        return qr

    def discard(self, handle: RequestHandle) -> None:
        """Forget a finished request's bookkeeping (a long-lived adapter —
        ``PlanServer.handle`` — would otherwise accumulate every result and
        event buffer). Only this request's events leave the engine-wide
        buffer."""
        self.handles.pop(handle.rid, None)
        if handle.result is not None and any(r is handle.result for r in self.results):
            self.results = [r for r in self.results if r is not handle.result]
        handle._events.clear()
        if any(ev.rid == handle.rid for ev in self._events):
            self._events = deque((ev for ev in self._events if ev.rid != handle.rid),
                                 maxlen=self._events.maxlen)

    def summary(self) -> str:
        # the engine's own total latency; handle() keeps its own accumulator
        return scheduler_summary(self.metrics, self.server.metrics,
                                 self.metrics.total_latency, pool=self.server.pool)

    # -- event plumbing ----------------------------------------------------
    def _push(self, ev: TokenEvent) -> None:
        self._events.append(ev)
        if self._tick_sink is not None:
            self._tick_sink.append(ev)
        handle = self.handles.get(ev.rid)
        if handle is not None:
            handle._events.append(ev)

    def _member_of(self, rid: int) -> Optional[_Member]:
        for group in self.active:
            for m in group.members:
                if m.qr.rid == rid:
                    return m
        return None

    def _register_token(self, m: _Member, tok: torch.Tensor, now: float,
                        step: int) -> Optional[str]:
        """Record one emitted ``(batch, 1)`` token for a member: event,
        TTFT / inter-token latency accounting, and the stop-condition
        checks. Returns the finish reason if a stop condition fired. The
        token goes to the host only where the request set one."""
        idx = m.emitted
        m.toks.append(tok)
        m.emitted += 1
        if idx == 0:
            self.metrics.observe_first_token(max(0.0, now - m.qr.arrival_s))
        else:
            self.metrics.observe_token_gap(max(0.0, now - m.last_t))
        m.last_t = now
        self._push(TokenEvent(rid=m.qr.rid, index=idx, token=tok, t=now, step=step))
        req = m.req
        if req.eos_id is None and not req.stop:
            return None
        tok_host = tok[:, 0].cpu().numpy()
        if m.rows_live is None:
            m.rows_live = np.ones(req.batch, bool)
        reason = None
        if req.eos_id is not None:
            m.rows_live &= tok_host != req.eos_id
            if not m.rows_live.any():
                reason = "eos"
        if reason is None and req.stop:
            if m.tails is None:
                m.tails = [[] for _ in range(req.batch)]
            max_len = max(len(s) for s in req.stop)
            for i in range(req.batch):
                if not m.rows_live[i]:
                    continue
                tail = m.tails[i]
                tail.append(int(tok_host[i]))
                del tail[:-max_len]
                if any(len(s) <= len(tail) and tail[len(tail) - len(s):] == list(s)
                       for s in req.stop):
                    m.rows_live[i] = False
            if not m.rows_live.any():
                reason = "stop"
        return reason

    # -- member lifecycle --------------------------------------------------
    def _admit_members(self, group: _Group, queued: List[QueuedRequest],
                       join_step: int, now: float) -> List[_Member]:
        """Admit ``queued`` into the group: lease and page-commit their arena
        rows through the pool's one admission helper, prefill them as one
        batch (engine ``prefill`` mode permitting), and seat them at their
        own positions in the step's buffers. Used both at group start
        (join_step 0) and for mid-decode joins."""
        srv = self.server
        dev = srv.device
        handoff = self.prefill and srv.model.supports_handoff
        total_batch = sum(qr.req.batch for qr in queued)
        span = max(srv.request_span(qr.req) for qr in queued)
        rows_per_member = [
            srv.pool.admit_request_rows(
                group.arena, qr.req.batch, prompt=qr.req.context if handoff else 0,
                span=srv.request_span(qr.req), eager=self.eager_pages)
            for qr in queued]
        rows_flat = [r for rows in rows_per_member for r in rows]
        rows_t = torch.tensor(rows_flat, dtype=torch.long, device=dev)

        lengths_rows = []
        for qr in queued:
            qr.start_s = now
            # once admitted (group start or join), a page denial is history
            self._page_denied_rids.discard(qr.rid)
            handle = self.handles.get(qr.rid)
            if handle is not None:
                handle.state = "active"
            lengths_rows += [qr.req.context] * qr.req.batch

        first, logits, pkv = None, None, None
        if self.prefill:
            # the span ends after the device has finished the admission's
            # prompt pass and handoff write (chip_smoke.py reads its device
            # time)
            with torch.profiler.record_function(PREFILL_SPAN):
                entry = srv.prefill_entry(total_batch, span)
                pb = entry.key.batch_bucket
                lengths = torch.tensor(lengths_rows + [1] * (pb - len(lengths_rows)),
                                       dtype=torch.int32, device=dev)
                logits, pkv = srv.run_prefill(entry, lengths=lengths)
                first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                if pkv is not None:
                    srv.pool.write_rows(group.arena, rows_flat, pkv,
                                        src_rows=range(len(rows_flat)))
                sync(dev)
        handed_off = pkv is not None
        del pkv
        if handed_off:
            pos_rows = lengths_rows
        else:  # no handoff (or no prefill): rows decode from zero state —
            # clear any state a prior tenant of these rows/pages left behind
            # (mid-decode joiners can inherit rows a completed member freed)
            if join_step > 0:
                srv.pool.zero_rows(group.arena, rows_flat)
            pos_rows = [0] * len(rows_flat)
        # the step's buffers take the new rows in place (a captured graph
        # reads them at their addresses)
        group.pos[rows_t] = torch.tensor(pos_rows, dtype=torch.int32, device=dev)
        seed = first[:len(rows_flat)] if first is not None else 1
        group.toks[rows_t] = seed

        members = []
        group.peak_rows = max(group.peak_rows, group.arena.rows_used)
        row_i = 0
        for qr, rows in zip(queued, rows_per_member):
            m = _Member(qr=qr, rows=rows,
                        rows_t=torch.tensor(rows, dtype=torch.long, device=dev),
                        join_step=join_step, base_pos=qr.req.context if handed_off else 0)
            row_i += qr.req.batch
            if logits is not None:
                m.prefill_logits = logits[row_i - qr.req.batch: row_i]
            members.append(m)
            group.members.append(m)
            if self.prefill and self.count_first:
                # the prefill token already is token #1: it is emitted at
                # admission (the time-to-first-token moment), and a 1-token
                # request completes before any decode step
                tok = first[row_i - qr.req.batch: row_i]
                reason = self._register_token(m, tok, now, join_step)
                if reason is not None or m.emitted >= qr.req.new_tokens:
                    self._complete(m, group, now, reason or "length")
        return members

    def _form_group(self, queued: List[QueuedRequest], now: float) -> Optional[_Group]:
        srv = self.server
        handoff = self.prefill and srv.model.supports_handoff
        total_batch = sum(qr.req.batch for qr in queued)
        span = max(srv.request_span(qr.req) for qr in queued)
        entry = srv.decode_entry(total_batch, span)
        b, s = entry.key.batch_bucket, entry.key.seq_bucket
        # page-exact admission demand: what this group's members commit
        # (rows + span pages), not the arena's bucket-shaped capacity
        demand = sum(srv.pool.member_bytes(s, qr.req.batch, srv.request_span(qr.req))
                     for qr in queued) if srv.pool.paged else None
        # the pool is the single owner of cache construction; force the
        # lease when nothing is in flight so progress is always possible.
        # A recycled arena may hold a previous tenant's state: families
        # without a prefill handoff decode from what they assume is a zero
        # cache, so their lease is zeroed (the handoff write overwrites
        # admitted rows wholesale)
        arena = srv.pool.acquire(b, s, zero=not handoff, force=not self.active,
                                 demand_bytes=demand)
        if arena is None:
            return None
        toks, pos = entry.step_fn.buffers(arena)
        toks.fill_(1)
        pos.zero_()
        group = _Group(entry=entry, arena=arena,
                       context=max(qr.req.context for qr in queued),
                       members=[], toks=toks, pos=pos)
        self._admit_members(group, queued, 0, now)
        self.metrics.observe_group([qr.req.batch for qr in queued], b)
        return group

    # -- tick phases -------------------------------------------------------
    def _phase_joins(self, group: _Group) -> None:
        """Absorb pending same-bucket requests into the group's free arena
        rows — and free cache *pages*, the real admission unit on a paged
        pool — prefilled at their own positions (token-level continuous
        batching). Joiners skip the line only for capacity the head-of-line
        request could not use anyway."""
        srv = self.server
        arena = group.arena
        free = arena.rows_free
        if not free:
            return
        fits = None
        if srv.pool.paged:
            state = {"pages": arena.allocator.available if arena.n_pages else None,
                     "bytes": srv.pool.bytes_room()}

            def fits(qr):
                span = srv.request_span(qr.req)
                pages = arena.span_pages(span) * qr.req.batch
                nbytes = srv.pool.member_bytes(arena.seq, qr.req.batch, span)
                if (state["pages"] is not None and pages > state["pages"]) \
                        or nbytes > state["bytes"]:
                    # count each backpressured *request* once, not once per
                    # tick it stays refused
                    if qr.rid not in self._page_denied_rids:
                        self._page_denied_rids.add(qr.rid)
                        srv.pool.metrics.pages_denied += 1
                    return False
                if state["pages"] is not None:
                    state["pages"] -= pages
                state["bytes"] -= nbytes
                self._page_denied_rids.discard(qr.rid)
                return True

        queued = self.queue.take_joinable(group.seq_bucket, free, fits=fits)
        if not queued:
            return
        members = self._admit_members(group, queued, group.steps_done, self.clock.now())
        self.metrics.observe_joins([m.req.batch for m in members])

    def _phase_form(self) -> None:
        """Coalesce + admit at most one new group (pool permitting)."""
        if not len(self.queue):
            return
        queued = self.queue.next_group()
        if not queued:
            return
        group = self._form_group(queued, self.clock.now())
        if group is None:
            # pool budget exhausted: requests wait (or join)
            self.queue.requeue_front(queued)
        else:
            self.active.append(group)

    def _phase_tick(self, group: _Group) -> None:
        """One decode tick for the group; emit each live member's token.

        The step (a graph replay on the card) updates the arena's cache in
        place and writes the greedy token and next position into the group's
        buffers; each member's token is gathered out of the token buffer
        right away, before the next tick overwrites it."""
        srv = self.server
        if srv.pool.paged:
            # grant the page covering each live row's next write position
            # (on-demand paging: drawn from the admission-time reservation,
            # so this can never fail mid-decode)
            for m in group.members:
                if not m.done:
                    wpos = m.base_pos + (group.steps_done - m.join_step)
                    srv.pool.ensure_decode_slots(group.arena, m.rows, wpos)
        step = group.entry.step_fn
        captured = step.capture_seconds
        group.logits = step(srv.params, group.arena, group.toks, group.pos)
        # a first tick on an arena captures the graph: plan-compile time
        srv.metrics.compile_seconds += step.capture_seconds - captured
        if self.sync_per_tick:
            sync(srv.device)
        group.steps_done += 1
        self.decode_ticks += 1
        now = self.clock.now()
        for m in group.members:
            if m.done:
                continue
            tok = group.toks[m.rows_t]
            reason = self._register_token(m, tok, now, group.steps_done)
            if reason is not None:
                self._complete(m, group, now, reason)
            elif m.emitted >= m.req.new_tokens:
                # every mode emits exactly new_tokens outputs; they differ
                # only in whether token #1 came from prefill or decode
                self._complete(m, group, now, "length")

    def _finish_record(self, handle: Optional[RequestHandle], **rec) -> Dict[str, Any]:
        # every record carries the full key set from birth; the plan-level
        # outcome is refined at group retire (queue-cancelled requests never
        # had a plan, so the defaults are their final values)
        rec.setdefault("plan", None)
        rec.setdefault("recompiled", False)
        rec.setdefault("recompile_reasons", ())
        rec.setdefault("watermark_bytes", 0.0)
        rec.setdefault("pool_bytes", 0.0)
        rec.setdefault("last_logits", None)
        self.results.append(rec)
        if handle is not None:
            handle.result = rec
            handle.state = "cancelled" if rec["finish_reason"] == "cancelled" else "done"
        return rec

    def _complete(self, m: _Member, group: _Group, now: float,
                  reason: str = "length") -> None:
        m.done = True
        m.finish_reason = reason
        m.qr.finish_s = now
        early = reason != "length"
        if reason == "cancelled":
            self.metrics.cancelled += 1
        else:
            self.metrics.observe_request(m.qr.queue_s, m.qr.exec_s)
            if early:
                self.metrics.early_exits += 1
        toks = torch.cat(m.toks, dim=1) if m.toks else _no_tokens(m.req.batch,
                                                                  self.server.device)
        # the logits of the pass that produced the member's last token: the
        # group's last tick (B, 1, V) if the member has ticked, else its
        # prompt pass
        last = (group.logits[:, -1][m.rows_t] if group.steps_done > m.join_step
                else m.prefill_logits)
        self._finish_record(
            self.handles.get(m.qr.rid),
            rid=m.qr.rid, batch=m.req.batch, context=m.req.context,
            bucket=(group.entry.key.batch_bucket, group.entry.key.seq_bucket),
            group_size=len(group.members), joined_at_step=m.join_step,
            tokens=toks, queue_s=m.qr.queue_s, exec_s=m.qr.exec_s,
            total_s=m.qr.total_s, finish_reason=reason, last_logits=last)
        self._push(TokenEvent(rid=m.qr.rid, index=m.emitted, token=None, t=now,
                              step=group.steps_done, done=True, finish_reason=reason))
        # freed rows — and, on early exits, their committed pages plus the
        # undrawn span reservation — become join capacity immediately
        self.server.pool.free_rows(group.arena, m.rows, early=early)

    def _retire_group(self, group: _Group) -> None:
        """Observed runtime statistics — including the cache pool's live
        bytes — feed dynamic recompilation; then the arena goes back to the
        pool for reuse. Completion records of the group's members are
        annotated with the plan-level outcome."""
        srv = self.server
        # the observed batch is the peak *concurrent* row usage — members
        # joining rows another member freed never widened the batch
        shape = InputShape(f"group_{group.peak_rows}x{group.context}",
                           group.seq_bucket, group.peak_rows, "decode")
        stats = srv.observed_stats(group.entry, shape, group.toks)
        refreshed, reasons = srv.observe(group.entry.key, stats)
        plan = (refreshed or group.entry).plan
        for m in group.members:
            # retiring members are finished: annotate their records with the
            # plan-level outcome, then stop tracking their handles
            handle = self.handles.pop(m.qr.rid, None)
            if handle is not None and handle.result is not None:
                handle.result.update(
                    plan=plan, recompiled=bool(reasons), recompile_reasons=reasons,
                    watermark_bytes=stats.watermark_bytes,
                    pool_bytes=stats.cache_pool_bytes)
        srv.pool.release(group.arena)
