"""PyTorch port, serving engine: ``repro_torch.runtime.engine.ServingEngine``
against the reference's ``repro.runtime.engine.ServingEngine`` on the same
weights (``repro_torch.interop``), float32, page 16, the paged decode
kernel, ``sanitize=True`` on both sides.

The traces are step-driven — requests submitted between explicit
``step()`` calls — so that neither engine's speed can change which requests
group or join. Each trace holds a group, mid-decode joins, a cancel of an
active and of a queued request, an EOS exit and a stop-sequence exit; one
also holds paged admission under a byte budget with denials. Per request
the token streams, the record fields and the completion order must be
equal, and so must the scheduler's counters and the KV pool's counters.

Prompts are all ones (``PlanServer``'s prompt pass); the weights are the
reference's seeded ones, the dense model's scaled by 4 so that its greedy
streams vary with the context instead of repeating one token.

The reference's ``CacheArena.tables`` may alias its numpy page table on the
CPU (``tests/test_torch_serve.py``); a fixture gives it a private copy at
upload, for this module only."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.analysis.sanitize import SanitizeError as JaxSanitizeError  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.runtime import kv_cache as jax_kv_cache  # noqa: E402
from repro.runtime.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.runtime.engine import VirtualClock as JaxVirtualClock  # noqa: E402
from repro.runtime.engine_config import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.runtime.serve_loop import PlanServer as JaxPlanServer  # noqa: E402
from repro.runtime.serve_loop import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.analysis.sanitize import SanitizeError  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.runtime.engine import ServingEngine, VirtualClock  # noqa: E402
from repro_torch.runtime.engine_config import EngineConfig  # noqa: E402
from repro_torch.runtime.serve_loop import PlanServer, ServeRequest  # noqa: E402

torch.set_num_threads(2)
# weight scale per arch: varied greedy streams from all-ones prompts
ARCHS = {"yi-6b-smoke": 4.0, "mamba2-1.3b-smoke": 1.0}
PAGE = 16
SCHED_COUNTERS = ("admitted", "completed", "groups", "coalesced_requests", "joins",
                  "join_rows", "peak_resident", "batch_slots_used", "batch_slots_total",
                  "cancelled", "early_exits", "slo_met", "slo_missed")
LATENCIES = ("queue_latency", "exec_latency", "total_latency", "ttft_latency",
             "itl_latency")
RECORD_FIELDS = ("batch", "context", "bucket", "group_size", "joined_at_step",
                 "finish_reason", "recompiled", "watermark_bytes", "pool_bytes")


def _private_tables(self):
    if self._tables_dirty:
        self._tables = jnp.asarray(self._tables_np.copy())
        self._tables_dirty = False
    return self._tables


@pytest.fixture(autouse=True, scope="module")
def _reference_tables_not_aliased():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_kv_cache.CacheArena, "tables", property(_private_tables))
        yield


def _configs(**config):
    common = dict(dtype="float32", page_size=PAGE, decode_kernel="paged", sanitize=True,
                  **config)
    return JaxEngineConfig(**common), EngineConfig(**common)


def reference_server(arch, **config):
    """The reference's server with its seeded weights, the dense model's
    scaled."""
    jsrv = JaxPlanServer(jax_config(arch), config=_configs(**config)[0])
    scale = np.float32(ARCHS[arch])
    jsrv.params = {k: jnp.asarray(np.asarray(v) * scale) if np.asarray(v).std() else v
                   for k, v in jsrv.params.items()}
    return jsrv


def port_server(arch, jsrv, **config):
    """The port's server (on the CPU) with ``jsrv``'s weights."""
    srv = PlanServer(get_config(arch), config=_configs(**config)[1], device="cpu")
    srv.params = interop.params_from_numpy({k: np.asarray(v) for k, v in jsrv.params.items()},
                                           torch.float32, "cpu")
    return srv


def make_servers(arch, **config):
    jsrv = reference_server(arch, **config)
    return jsrv, port_server(arch, jsrv, **config)


class Side:
    """One package's engine driven by a trace; requests keyed by name."""

    def __init__(self, engine, request_cls):
        self.engine = engine
        self.request_cls = request_cls
        self.handles = {}

    def apply(self, trace, stops=None):
        """Run ``trace``: ("submit", name, batch, context, new_tokens[,
        "eos" | "stop"]), ("step", n), ("cancel", name), then drain. An
        "eos"/"stop" request takes its condition from ``stops`` (one that
        never fires where ``stops`` is None)."""
        for op in trace:
            if op[0] == "submit":
                name, batch, ctx, new = op[1:5]
                kind = op[5] if len(op) > 5 else None
                kw = {}
                if kind == "eos":
                    kw["eos_id"] = stops[name] if stops else -1
                elif kind == "stop":
                    kw["stop"] = (stops[name] if stops else (-1,),)
                self.handles[name] = self.engine.submit(
                    self.request_cls(batch, ctx, new, **kw))
            elif op[0] == "step":
                for _ in range(op[1]):
                    self.engine.step()
            else:
                assert self.engine.cancel(self.handles[op[1]])
        self.engine.drain()
        return self

    def streams(self):
        return {name: np.asarray(h.result["tokens"]) for name, h in self.handles.items()}

    def records(self):
        names = {h.rid: name for name, h in self.handles.items()}
        return [(names[r["rid"]], tuple(r[f] for f in RECORD_FIELDS))
                for r in self.engine.results]

    def counters(self):
        m = self.engine.metrics
        return ({k: getattr(m, k) for k in SCHED_COUNTERS},
                {k: getattr(m, k).count for k in LATENCIES})


def first_new(stream):
    """(index, token) of the first token that did not occur before it, past
    the first."""
    return next((i, t) for i, t in enumerate(stream) if i and t not in stream[:i])


def first_new_pair(stream):
    """(index, pair) of the first adjacent pair that did not occur before,
    past the second token."""
    pairs = list(zip(stream, stream[1:]))
    return next((i + 1, p) for i, p in enumerate(pairs) if i and p not in pairs[:i])


def run_both(arch, trace, **config):
    """The trace through both engines. EOS and stop requests take the first
    token (pair) of their own stream that is new — read from a first run of
    the port's engine in which their conditions never fire, so the final
    runs fire them mid-stream."""
    jsrv, srv = make_servers(arch, **config)
    probe = Side(ServingEngine(srv, clock=VirtualClock()), ServeRequest).apply(trace)
    marks = {op[1]: op[5] for op in trace if op[0] == "submit" and len(op) > 5}
    stops = {}
    for name, kind in marks.items():
        stream = probe.streams()[name][0].tolist()
        stops[name] = (first_new(stream)[1] if kind == "eos"
                       else tuple(first_new_pair(stream)[1]))
    srv = port_server(arch, jsrv, **config)
    port = Side(ServingEngine(srv, clock=VirtualClock()), ServeRequest).apply(trace, stops)
    ref = Side(JaxEngine(jsrv, clock=JaxVirtualClock()), JaxRequest).apply(trace, stops)
    return ref, port, probe, stops


def assert_equal_runs(ref, port):
    rs, ps = ref.streams(), port.streams()
    assert rs.keys() == ps.keys()
    for name in rs:
        np.testing.assert_array_equal(ps[name], rs[name], err_msg=name)
    assert port.records() == ref.records()
    assert port.counters() == ref.counters()
    assert port.engine.server.pool.metrics.as_dict() == ref.engine.server.pool.metrics.as_dict()
    assert port.engine.server.pool.live_bytes() == ref.engine.server.pool.live_bytes() == 0
    assert port.engine.decode_ticks > 0


# a group of three at (8, 128), joins into its free rows and into rows that
# finished members free, an EOS and a stop-sequence exit, a cancel of an
# active member (its rows admit a waiting request) and of a queued request
# (8 rows: it can neither join nor form while the one arena is leased)
LIFECYCLE = [("submit", "a", 4, 100, 12), ("submit", "b", 1, 90, 3),
             ("submit", "c", 1, 110, 4), ("step", 1),
             ("submit", "d", 1, 95, 10, "eos"), ("submit", "e", 1, 100, 10, "stop"),
             ("submit", "f", 2, 80, 5), ("submit", "g", 8, 100, 3), ("step", 3),
             ("cancel", "a"), ("cancel", "g"), ("step", 1), ("submit", "h", 1, 60, 4)]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_lifecycle_trace_matches_reference(arch):
    ref, port, probe, stops = run_both(arch, LIFECYCLE, pool_max_arenas=1)
    assert_equal_runs(ref, port)
    reasons = {n: h.result["finish_reason"] for n, h in port.handles.items()}
    assert reasons == dict(a="cancelled", b="length", c="length", d="eos", e="stop",
                           f="length", g="cancelled", h="length")
    assert port.engine.metrics.joins >= 3
    assert port.handles["g"].result["tokens"].shape == (8, 0)
    # the early exits are prefixes of the same requests' full streams
    full = probe.streams()
    for name in ("d", "e"):
        got = port.streams()[name][0].tolist()
        assert got == full[name][0].tolist()[:len(got)]
    assert port.streams()["d"][0, -1] == stops["d"]
    assert tuple(port.streams()["e"][0, -2:]) == stops["e"]


def test_paged_admission_under_a_byte_budget_matches_reference():
    """Joins are admitted by free pages and bytes, not rows alone: with a
    budget that holds the group and one joiner, the next joiner is denied
    (counted once) until an early exit gives its pages back."""
    arch = "yi-6b-smoke"
    pool = port_server(arch, reference_server(arch)).pool
    budget = pool.member_bytes(128, 5, 110) + pool.member_bytes(128, 1, 100) + 1.0
    trace = [("submit", "a", 5, 100, 10), ("step", 1),
             ("submit", "b", 1, 90, 10, "eos"), ("submit", "c", 1, 100, 8),
             ("submit", "d", 1, 80, 6), ("step", 2), ("submit", "e", 1, 70, 5)]
    ref, port, _, _ = run_both(arch, trace, pool_max_bytes=budget)
    assert_equal_runs(ref, port)
    pm = port.engine.server.pool.metrics
    assert pm.pages_denied >= 1 and pm.pages_reclaimed > 0
    assert port.handles["b"].result["finish_reason"] == "eos"
    assert port.engine.metrics.joins >= 2


def test_stream_events_and_handle_tokens_match_records():
    """Streaming is observation: the events of each request concatenate to
    its record's tokens, indices count up from 0, the terminal event
    carries the finish reason, and a partial output is visible mid-decode."""
    _, srv = make_servers("yi-6b-smoke")
    eng = ServingEngine(srv)
    h = eng.submit(ServeRequest(2, 40, 6))
    other = eng.submit(ServeRequest(1, 30, 3))
    it = h.stream()
    first = [next(it), next(it)]
    assert [e.index for e in first] == [0, 1]
    assert h.result is None and h.tokens().shape == (2, 2)
    rest = list(it)
    assert rest[-1].done and rest[-1].finish_reason == "length"
    toks = torch.cat([e.token for e in first + rest if e.token is not None], dim=1)
    assert torch.equal(toks, h.result["tokens"])
    eng.drain()
    assert other.result["tokens"].shape == (1, 3)
    assert h.result["last_logits"].shape == (2, get_config("yi-6b-smoke").vocab_size)
    assert not eng.cancel(h)


def test_handle_is_the_engine_adapter():
    """``PlanServer.handle`` serves through the server's own engine: the same
    request through a fresh engine on the same server gives the same
    tokens, and handle leaves no record, handle or event behind."""
    _, srv = make_servers("yi-6b-smoke", prefill=True)
    out = srv.handle(ServeRequest(2, 40, 5))
    eng = srv._engine
    assert isinstance(eng, ServingEngine) and not eng.join_mid_decode
    assert (eng.eager_pages, eng.sync_per_tick) == (True, False)
    assert eng.results == [] and eng.handles == {} and not eng._events
    fresh = ServingEngine(srv)
    h = fresh.submit(ServeRequest(2, 40, 5))
    fresh.drain()
    assert torch.equal(out["tokens"], h.result["tokens"])
    assert out["decode_steps"] == 4


def test_a_server_that_served_is_freed_without_the_garbage_collector():
    """``handle``'s engine must not hold its server in a reference cycle:
    a dropped server (weights, arenas, decode graphs) goes at once."""
    import gc
    import weakref

    _, srv = make_servers("yi-6b-smoke", prefill=True)
    srv.handle(ServeRequest(1, 40, 3))
    ref = weakref.ref(srv)
    gc.disable()
    try:
        del srv
        assert ref() is None
    finally:
        gc.enable()


def test_rid_is_stamped_at_construction_and_resubmission_refused():
    _, srv = make_servers("yi-6b-smoke")
    eng = ServingEngine(srv)
    r1, r2 = ServeRequest(1, 40, 2), ServeRequest(1, 40, 2)
    assert r2.rid == r1.rid + 1
    h = eng.submit(r2)
    with pytest.raises(ValueError, match="already in flight"):
        eng.submit(r2)
    eng.drain()
    assert h.rid == r2.rid == h.result["rid"] == h.qr.rid


@pytest.mark.parametrize("plant", ["reserve-drift", "row-double-free", "handle-leak",
                                   "page-leak"])
def test_sanitizer_catches_planted_drift_in_both_packages(plant):
    """The same planted bookkeeping drift fails the next sanitized tick with
    the same rule in both packages."""
    jsrv, srv = make_servers("yi-6b-smoke")
    rules = {}
    for side, eng, req, err in (("ref", JaxEngine(jsrv), JaxRequest, JaxSanitizeError),
                                ("port", ServingEngine(srv), ServeRequest, SanitizeError)):
        eng.submit(req(3, 40, 6))
        eng.step()
        arena = eng.active[0].arena
        if plant == "reserve-drift":
            arena.allocator.reserved += 1
        elif plant == "row-double-free":
            arena._free.append(arena._free[0])
        elif plant == "handle-leak":
            eng.handles[-7] = eng.handles[next(iter(eng.handles))]
        else:
            arena.allocator._free_set.discard(next(iter(arena.allocator._free_set)))
        with pytest.raises(err) as info:
            eng.step()
        rules[side] = sorted({f.rule for f in info.value.findings})
    assert rules["port"] == rules["ref"]
    assert plant in rules["port"]


def test_withdraw_matches_reference():
    """A withdrawn request (a router's failover primitive) leaves without a
    record or terminal event, gives its admission back and frees its rows
    and pages at once — the same counters in both packages."""
    jsrv, srv = make_servers("yi-6b-smoke")
    sides = []
    for eng, req in ((JaxEngine(jsrv), JaxRequest), (ServingEngine(srv), ServeRequest)):
        a, b = eng.submit(req(2, 40, 6)), eng.submit(req(1, 30, 4))
        eng.step()
        q = eng.submit(req(4, 100, 3))
        qr = eng.withdraw(a)
        assert qr.rid == a.rid and a.state == "withdrawn" and a.result is None
        assert eng.withdraw(q).rid == q.rid and not eng.withdraw(a)
        eng.drain()
        assert b.result["finish_reason"] == "length" and a.result is None
        sides.append((eng.metrics.admitted, eng.metrics.completed, len(eng.results),
                      eng.server.pool.metrics.as_dict(), eng.server.pool.live_bytes()))
    assert sides[1] == sides[0]
    assert sides[1][:3] == (1, 1, 1) and sides[1][4] == 0


def test_clocks_protocol_and_metrics_format_match_reference():
    from repro.runtime.engine import EngineClient as JaxEngineClient
    from repro.runtime.engine import ReplicaClock as JaxReplicaClock
    from repro.runtime.metrics import format_metrics as jax_format
    from repro_torch.runtime.engine import EngineClient, ReplicaClock, WallClock
    from repro_torch.runtime.metrics import format_metrics

    # a paused replica clock only moves by skips, never backwards
    for cls in (ReplicaClock, JaxReplicaClock):
        c = cls()
        c.advance_to(2.5)
        c.advance_to(1.0)
        assert (c.now(), c.running) == (2.5, False)
        c.resume()
        assert c.running and c.now() >= 2.5
        c.pause()
        t = c.now()
        assert not c.running and c.now() == t >= 2.5
    v = VirtualClock()
    v.advance_to(100.0)
    assert 100.0 <= v.now() < 101.0
    assert WallClock().now() >= 0.0
    _, srv = make_servers("yi-6b-smoke")
    assert isinstance(ServingEngine(srv), EngineClient)
    assert {m for m in dir(EngineClient) if not m.startswith("_")} == \
        {m for m in dir(JaxEngineClient) if not m.startswith("_")}
    rec = {"step": 3, "loss": 0.123456, "lr": 1e-3, "name": "x"}
    assert format_metrics(rec) == jax_format(rec)
