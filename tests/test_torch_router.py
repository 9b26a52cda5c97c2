"""PyTorch port, multi-replica router: ``repro_torch.runtime.router.EngineRouter``
against the reference's ``repro.runtime.router.EngineRouter`` on the same
weights (``repro_torch.interop``), float32, page 16, the paged decode
kernel, ``sanitize=True`` on both sides; the port's replicas share one set of
weight tensors, the reference's hold seed-equal copies.

Placement with every request submitted at one arrival instant reads only
discrete replica state, so the port's decisions must equal the reference's.
``run`` places by wall-derived replica clocks, so its traces are compared by
request (tokens per request), not by completion order or replica. The
failover trace's streams must be gapless and byte-identical to the
reference's undisturbed run. The fleet counters, summaries and sanitizer
findings must read as the reference's on the same observations and faults.

Prompts are all ones (``PlanServer``'s prompt pass); the weights are the
reference's seeded ones scaled by 4 (``tests/test_torch_engine.py``), so the
greedy streams vary."""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.analysis.sanitize import check_router as jax_check_router  # noqa: E402
from repro.runtime import kv_cache as jax_kv_cache  # noqa: E402
from repro.runtime import metrics as jax_metrics  # noqa: E402
from repro.runtime.router import EngineRouter as JaxRouter  # noqa: E402
from repro.runtime.scheduler import simulate_arrivals as jax_arrivals  # noqa: E402
from repro.runtime.serve_loop import ServeRequest as JaxRequest  # noqa: E402
from repro_torch.analysis.sanitize import check_router  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import serve_batched, serve_engine, serve_router  # noqa: E402
from repro_torch.runtime import metrics  # noqa: E402
from repro_torch.runtime.engine import EngineClient, ServingEngine  # noqa: E402
from repro_torch.runtime.engine_config import EngineConfig  # noqa: E402
from repro_torch.runtime.router import EngineRouter  # noqa: E402
from repro_torch.runtime.scheduler import simulate_arrivals  # noqa: E402
from repro_torch.runtime.serve_loop import PlanServer, ServeRequest  # noqa: E402
from test_torch_engine import _private_tables, port_server, reference_server  # noqa: E402

torch.set_num_threads(2)
ARCH = "yi-6b-smoke"
REPLICAS = 2
# the reference's failover trace (tests/test_router.py): six batch-1
# requests of 8 new tokens, arriving at 200/s from seed 3
FAILOVER_SHAPES = [(1, 40, 8), (1, 44, 8), (1, 52, 8), (1, 40, 8), (1, 56, 8), (1, 48, 8)]
# the reference's placement property: batch x context, 4 new tokens each
SHAPES = st.lists(st.tuples(st.sampled_from([1, 2, 4]), st.sampled_from([40, 52, 100, 112])),
                  min_size=2, max_size=6)


@pytest.fixture(autouse=True, scope="module")
def _reference_tables_not_aliased():
    """The reference's ``CacheArena.tables`` may alias its numpy page table
    on the CPU (``tests/test_torch_serve.py``): a private copy at upload."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_kv_cache.CacheArena, "tables", property(_private_tables))
        yield


def reference_fleet():
    return [reference_server(ARCH, replicas=REPLICAS) for _ in range(REPLICAS)]


def port_fleet(jsrv):
    """The port's replicas: the first takes ``jsrv``'s weights, the others
    share its tensors (what ``EngineConfig.build_client`` does)."""
    servers = [port_server(ARCH, jsrv, replicas=REPLICAS)]
    for _ in range(1, REPLICAS):
        srv = PlanServer(get_config(ARCH), config=servers[0].config, device="cpu")
        srv.params = servers[0].params
        servers.append(srv)
    return servers


@pytest.fixture(scope="module")
def fleets():
    """(reference servers, port servers), shared by the decode-heavy tests:
    plan caches warm up across tests, the weights never change."""
    jsrvs = reference_fleet()
    return jsrvs, port_fleet(jsrvs[0])


def _routers(fleets, **config):
    jsrvs, srvs = fleets
    jcfg = dataclasses.replace(jsrvs[0].config, **config)
    cfg = dataclasses.replace(srvs[0].config, **config)
    return JaxRouter(jsrvs, config=jcfg), EngineRouter(srvs, config=cfg)


def _decisions(router, first, then=()):
    """Submit ``first`` at arrival 0, tick once if ``then`` follows, submit
    ``then`` at arrival 0; the decisions as (replica, reason)."""
    req = JaxRequest if isinstance(router, JaxRouter) else ServeRequest
    for b, c in first:
        router.submit(req(b, c, 4), arrival_s=0.0)
    if then:
        router.step()
        for b, c in then:
            router.submit(req(b, c, 4), arrival_s=0.0)
    return [(d.replica, d.reason) for d in router.decisions]


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


@settings(max_examples=6, deadline=None, database=None)
@given(shapes=SHAPES, warm=st.sampled_from([None, 64, 128]))
def test_placement_decisions_match_reference(fleets, shapes, warm):
    """Fresh fleets, optionally with replica 1's plan cache warm for one
    bucket: the same requests at one arrival instant place identically."""
    jsrvs = reference_fleet()
    srvs = port_fleet(jsrvs[0])
    if warm is not None:
        jsrvs[1].decode_entry(1, warm - 4)
        srvs[1].decode_entry(1, warm - 4)
    got = _decisions(EngineRouter(srvs), shapes)
    want = _decisions(JaxRouter(jsrvs, config=jsrvs[0].config), shapes)
    assert got == want
    assert {r for r, _ in got} <= set(range(REPLICAS))


def test_placement_after_a_tick_matches_reference():
    """With groups in flight, the join, queue and warm-plan signals decide:
    the same decisions as the reference's, joins among them."""
    first = [(3, 40), (1, 100)]
    then = [(1, 44), (2, 112), (1, 52), (4, 100), (1, 40)]
    jsrvs = reference_fleet()
    srvs = port_fleet(jsrvs[0])
    got = _decisions(EngineRouter(srvs), first, then)
    want = _decisions(JaxRouter(jsrvs, config=jsrvs[0].config), first, then)
    assert got == want
    assert "join" in {reason for _, reason in got}


@settings(max_examples=6, deadline=None, database=None)
@given(shapes=SHAPES)
def test_placement_determinism_property(shapes):
    """Identical request sequences into identically built port fleets place
    identically: the affinity score never reads the wall clock."""
    cfg = EngineConfig(replicas=REPLICAS, dtype="float32", page_size=16, sanitize=True)
    runs = [_decisions(cfg.build_client(get_config(ARCH), device="cpu"), shapes)
            for _ in range(2)]
    assert runs[0] == runs[1]


def test_load_placement_never_picks_a_draining_replica(fleets):
    """``"load"`` ranks by queue pressure and the observed TTFT tail; a
    draining replica is never a candidate, and everything completes."""
    _, router = _routers(fleets, placement="load")
    early = [router.submit(ServeRequest(b, c, 4)) for b, c in ((1, 40), (2, 100))]
    router.step()
    moved = router.drain_replica(1)
    n = len(router.decisions)
    late = [router.submit(ServeRequest(b, c, 4)) for b, c in ((4, 52), (1, 112), (2, 40))]
    router.drain()
    assert all(d.replica == 0 for d in router.decisions[n:])
    assert all(h.done and h.result["finish_reason"] == "length" for h in early + late)
    assert router.router_metrics.resubmitted == len(moved)
    assert len(router.results) == len(early) + len(late)


# ---------------------------------------------------------------------------
# lifecycle: run, stream, cancel
# ---------------------------------------------------------------------------


def test_run_completes_all_on_both_replicas_tokens_equal_reference(fleets):
    jrouter, router = _routers(fleets)
    reqs = [ServeRequest(4, 48, 4) for _ in range(8)]
    jreqs = [JaxRequest(4, 48, 4) for _ in range(8)]
    recs = {r["rid"]: r for r in router.run(simulate_arrivals(reqs))}
    jrecs = {r["rid"]: r for r in jrouter.run(jax_arrivals(jreqs))}
    assert set(recs) == {r.rid for r in reqs} and len(jrecs) == len(jreqs)
    assert all(r.engine.metrics.admitted > 0 for r in router.replicas)
    assert router.metrics.completed == len(reqs)
    for req, jreq in zip(reqs, jreqs):
        np.testing.assert_array_equal(recs[req.rid]["tokens"].numpy(),
                                      np.asarray(jrecs[jreq.rid]["tokens"]))
    s = router.summary()
    assert "replica[0]" in s and "replica[1]" in s and "fleet:" in s


def test_stream_and_cancel_match_reference(fleets):
    out = []
    for router, req in zip(_routers(fleets), (JaxRequest, ServeRequest)):
        keep = router.submit(req(1, 40, 4))
        victim = router.submit(req(1, 40, 12))
        seen, reasons = [], []
        for ev in victim.stream():
            if ev.token is not None:
                seen.append(int(np.asarray(ev.token)[0, 0]))
                if len(seen) == 2:
                    assert victim.cancel()
            if ev.done:
                reasons.append(ev.finish_reason)
        router.drain()
        assert keep.done and keep.result["finish_reason"] == "length"
        assert reasons == ["cancelled"] and victim.result["tokens"].shape[1] == 2
        assert not victim.cancel() and not router.handles
        out.append((seen, np.asarray(keep.result["tokens"]).tolist()))
    assert out[1] == out[0]


def test_engine_client_surface_matches_reference(fleets):
    from repro.runtime.engine import EngineClient as JaxEngineClient

    _, router = _routers(fleets)
    assert isinstance(router, EngineClient)
    assert isinstance(ServingEngine(fleets[1][0]), EngineClient)
    public = {m for m in dir(EngineRouter) if not m.startswith("_")}
    assert public == {m for m in dir(JaxRouter) if not m.startswith("_")}
    assert {m for m in dir(JaxEngineClient) if not m.startswith("_")} <= public


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------


def test_drain_failover_zero_loss_streams_equal_reference_undisturbed(fleets):
    """Replica 1 drained after a token of index >= 2 while it holds live
    work: every request completes, each stream is gapless (indices 0, 1, ...
    exactly once) and byte-identical to the reference's undisturbed run of
    the same trace, and the drained replica takes no further placement."""
    jrouter, router = _routers(fleets)
    jreqs = [JaxRequest(*s) for s in FAILOVER_SHAPES]
    ref = {r["rid"]: np.asarray(r["tokens"])
           for r in jrouter.run(jax_arrivals(jreqs, rate_per_s=200, seed=3))}
    reqs = [ServeRequest(*s) for s in FAILOVER_SHAPES]
    streamed, indices, drained_at = {}, {}, []

    def on_event(ev):
        if (not drained_at and ev.token is not None and ev.index >= 2
                and any(h.replica is not None and h.replica.idx == 1
                        for h in router.handles.values())):
            assert router.drain_replica(1), "drain found no live work to move"
            drained_at.append(len(router.decisions))
        if ev.token is not None:
            streamed.setdefault(ev.rid, []).append(ev.token.numpy())
            indices.setdefault(ev.rid, []).append(ev.index)

    res = router.run(simulate_arrivals(reqs, rate_per_s=200, seed=3), on_event=on_event)
    assert drained_at, "drain trigger never fired"
    assert len(res) == len(reqs) and not router.handles          # zero loss
    assert router.router_metrics.resubmitted > 0
    failovers = router.decisions[drained_at[0] - router.router_metrics.resubmitted:]
    assert all(d.replica != 1 for d in failovers)
    for req, jreq in zip(reqs, jreqs):
        toks = np.concatenate(streamed[req.rid], axis=1)
        assert indices[req.rid] == list(range(req.new_tokens))
        np.testing.assert_array_equal(toks, ref[jreq.rid])
        rec = next(x for x in res if x["rid"] == req.rid)
        np.testing.assert_array_equal(toks, rec["tokens"].numpy())


def test_cannot_drain_last_replica_and_restore_rejoins(fleets):
    jrouter, router = _routers(fleets)
    for r in (jrouter, router):
        r.drain_replica(1)
        assert r.drain_replica(1) == []
        with pytest.raises(ValueError, match="last live replica"):
            r.drain_replica(0)
        assert r.router_metrics.drained == 1
        r.restore_replica(1)
        assert r.router_metrics.drained == 0 and not r.replicas[1].draining
    assert router.router_metrics.summary() == jrouter.router_metrics.summary()
    assert router.replicas[1].server.params is router.replicas[0].server.params


@settings(max_examples=5, deadline=None, database=None)
@given(shapes=st.lists(st.sampled_from([(1, 40, 4), (1, 100, 4), (2, 44, 4)]),
                       min_size=3, max_size=7))
def test_starvation_freedom_property(fleets, shapes):
    """At every tick boundary (after the tick's rebalance), no replica sits
    idle while another replica still holds queued work."""
    _, router = _routers(fleets)
    for b, c, n in shapes:
        router.submit(ServeRequest(b, c, n))
    while not router.idle:
        router.step()
        router._rebalance()  # what the next tick would apply first
        for r in router.replicas:
            queued_elsewhere = any(len(d.engine.queue) for d in router.replicas if d is not r)
            assert not (r.engine.idle and queued_elsewhere), (
                f"replica {r.idx} idle while another replica has queued work")
    assert not router.handles and len(router.results) == len(shapes)


# ---------------------------------------------------------------------------
# fleet metrics, sanitizer
# ---------------------------------------------------------------------------


def _observed(mod, seed):
    """A SchedulerMetrics of package ``mod`` fed one seeded sequence of
    observations."""
    rng = np.random.default_rng(seed)
    m = mod.SchedulerMetrics(slo_s=0.05)
    m.admitted, m.cancelled, m.early_exits = 5 + seed, seed, 1
    m.observe_group([1, 2], 4)
    m.observe_joins([1])
    m.observe_resident(3 + seed)
    for q, e, t, g in rng.uniform(0.0, 0.06, (4 + seed, 4)):
        m.observe_request(float(q), float(e))
        m.observe_first_token(float(t))
        m.observe_token_gap(float(g))
    return m


def _fake_router(router_metrics, parts, pool):
    replicas = [types.SimpleNamespace(idx=i, draining=i == 1,
                                      engine=types.SimpleNamespace(metrics=m),
                                      clock=types.SimpleNamespace(now=lambda i=i: 0.25 * i),
                                      server=types.SimpleNamespace(pool=pool))
                for i, m in enumerate(parts)]
    return types.SimpleNamespace(replicas=replicas, router_metrics=router_metrics,
                                 config=types.SimpleNamespace(placement="affinity"))


def test_fleet_metrics_and_summaries_equal_reference():
    jsrv = reference_server(ARCH)
    sides = {}
    for name, mod, pool in (("ref", jax_metrics, jsrv.pool),
                            ("port", metrics, port_server(ARCH, jsrv).pool)):
        parts = [_observed(mod, s) for s in range(3)]
        merged = mod.merge_scheduler_metrics(parts)
        rm = mod.RouterMetrics(failovers=1, resubmitted=2, drained=1)
        for reason in ("idle", "warm", "join", "idle", "failover"):
            rm.observe_placement(reason)
        sides[name] = (merged.summary(), merged.peak_resident, merged.ttft_latency.count,
                       rm.summary(), mod.router_summary(_fake_router(rm, parts, pool)))
    assert sides["port"] == sides["ref"]
    assert sides["port"][1] == 3 + 4 + 5          # peaks summed
    assert sides["port"][2] == 4 + 5 + 6          # samples pooled


class _Overfull(list):
    """A stand-in event buffer past its cap (a bounded deque never is)."""

    maxlen = 0


@pytest.mark.parametrize("plant", ["handle-key", "handle-finished", "handle-missing",
                                   "event-buffer-leak"])
def test_check_router_findings_equal_reference(plant):
    """The same planted fault gives the same finding kinds in both
    packages."""
    jsrvs = reference_fleet()
    rules = {}
    for side, router, req in (("ref", JaxRouter(jsrvs, config=jsrvs[0].config), JaxRequest),
                              ("port", EngineRouter(port_fleet(jsrvs[0])), ServeRequest)):
        handles = [router.submit(req(1, 40, 4), arrival_s=0.0) for _ in range(3)]
        assert (jax_check_router if side == "ref" else check_router)(router) == []
        h = handles[0]
        if plant == "handle-key":
            router.handles[-7] = h
        elif plant == "handle-finished":
            h.inner.result = {"tokens": None}
        elif plant == "handle-missing":
            h.replica.engine.queue.remove(h.rid)
        else:
            router._events = _Overfull([None])
        found = (jax_check_router if side == "ref" else check_router)(router)
        rules[side] = sorted({f.rule for f in found})
    assert rules["port"] == rules["ref"]
    assert rules["port"]


# ---------------------------------------------------------------------------
# build_client, launchers
# ---------------------------------------------------------------------------


def test_build_client_is_the_topology_switch():
    cfg = get_config(ARCH)
    one = EngineConfig().build_client(cfg, device="cpu")
    assert type(one) is ServingEngine
    fleet = EngineConfig(replicas=2).build_client(cfg, device="cpu")
    assert isinstance(fleet, EngineRouter) and len(fleet.replicas) == 2
    p0, p1 = (r.server.params for r in fleet.replicas)
    assert p0.keys() == p1.keys()
    assert all(p0[k] is p1[k] and p0[k].data_ptr() == p1[k].data_ptr() for k in p0)
    # each replica's planner still counts the whole weight bytes
    assert fleet.replicas[1].server._params_bytes == fleet.replicas[0].server._params_bytes > 0
    warm = EngineConfig(replicas=2).build_client(
        cfg, servers=[r.server for r in fleet.replicas])
    assert [r.server for r in warm.replicas] == [r.server for r in fleet.replicas]


@pytest.mark.parametrize("name,main,argv,expect", [
    ("serve_engine", serve_engine.main, ["--device", "cpu"], "c finished"),
    ("serve_batched", serve_batched.main,
     ["--device", "cpu", "--arch", "yi-6b-smoke", "--gen", "8"], "OK"),
    ("serve_router", serve_router.main, ["--device", "cpu"], "all 6 requests completed"),
    ("serve --replicas 2 --drain-replica 1", serve_cli.main,
     ["--arch", ARCH, "--scheduler", "--replicas", "2", "--drain-replica", "1",
      "--requests", "8", "--tokens", "4", "--sanitize", "--device", "cpu"],
     "# drained replica 1; resubmitted"),
])
def test_launchers_run_end_to_end(capsys, name, main, argv, expect):
    main(argv)
    out = capsys.readouterr().out
    assert expect in out, out
    if name.startswith("serve --replicas"):
        assert "router: replicas=2 placement=affinity" in out
        assert "fleet: scheduler: admitted=8 completed=8" in out


def test_launcher_refuses_a_replica_it_does_not_have():
    with pytest.raises(SystemExit, match=r"--drain-replica 2: no such replica \(--replicas 2\)"):
        serve_cli.main(["--arch", ARCH, "--scheduler", "--replicas", "2",
                        "--drain-replica", "2", "--device", "cpu"])
