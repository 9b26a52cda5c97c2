"""PyTorch port, continuous-batching scheduler: ``ContinuousBatchingScheduler``
and ``RequestQueue`` against the reference's, and the launcher's
single-shot and ``--scheduler`` modes on the CPU.

Closed bursts (every arrival at t = 0) replay through both schedulers on the
same weights (float32, page 16, paged decode kernel, ``sanitize=True``):
which requests group or join then depends on the trace alone, not on either
engine's speed, so token streams, records, the scheduler's counters and the
KV pool's counters must be equal. Timed Poisson arrivals run through the
port alone. ``RequestQueue``'s selection, joins and requeues are held
against the reference's queue on random request sequences (plain
``hypothesis``)."""

import contextlib
import io
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core.plan_cache import BucketPolicy as JaxBucketPolicy  # noqa: E402
from repro.runtime.engine import VirtualClock as JaxVirtualClock  # noqa: E402
from repro.runtime.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.runtime.scheduler import RequestQueue as JaxQueue  # noqa: E402
from repro.runtime.scheduler import simulate_arrivals as jax_arrivals  # noqa: E402
from repro.runtime.serve_loop import ServeRequest as JaxRequest  # noqa: E402
from repro_torch.core.plan_cache import BucketPolicy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.runtime.engine import VirtualClock  # noqa: E402
from repro_torch.runtime.scheduler import (ContinuousBatchingScheduler,  # noqa: E402
                                           RequestQueue, simulate_arrivals)
from repro_torch.runtime.serve_loop import ServeRequest  # noqa: E402
from test_torch_engine import (RECORD_FIELDS, SCHED_COUNTERS,  # noqa: E402
                               _reference_tables_not_aliased, first_new, make_servers,
                               port_server)

torch.set_num_threads(2)
assert _reference_tables_not_aliased     # the module-scoped fixture, used here too

# (batch, context, new_tokens): every span in the 128 bucket, 14 rows for
# an 8-row group, so the rest joins as members finish
BURST = ((2, 100, 6), (1, 90, 3), (1, 110, 9), (4, 70, 5), (2, 100, 4), (1, 95, 7),
         (1, 60, 8), (2, 80, 3))


def replay(sched_cls, request_cls, srv, clock, specs, cancel_after=0, eos=None,
           select="hol"):
    """A closed burst through one package's scheduler; the request at index
    1 of ``specs`` gets ``eos``, and every request is cancelled after its
    ``cancel_after``-th token (0: never). Returns the scheduler and, per
    index, the record."""
    reqs = [request_cls(b, c, n, eos_id=eos if i == 1 else None)
            for i, (b, c, n) in enumerate(specs)]
    index = {r.rid: i for i, r in enumerate(reqs)}
    sched = sched_cls(srv, config=replace(srv.config, bucket_select=select), clock=clock)

    def on_event(ev):
        if ev.token is not None and ev.index + 1 >= cancel_after:
            handle = sched.engine.handles.get(ev.rid)
            if handle is not None:
                sched.engine.cancel(handle)

    arrivals = [(0.0, r) for r in reqs]
    sched.run(arrivals, on_event=on_event if cancel_after else None)
    return sched, {index[r["rid"]]: r for r in sched.results}, [index[r["rid"]]
                                                               for r in sched.results]


@pytest.mark.parametrize("case", ["plain", "eos-and-cancel", "arrival-select"])
def test_closed_burst_matches_reference(case):
    arch = "yi-6b-smoke"
    kw = dict(pool_max_arenas=1) if case != "arrival-select" else {}
    specs = BURST
    if case == "arrival-select":
        # two buckets: the 128 bucket has more rows pending than the 64
        # bucket at the head, so "arrival" forms it first
        specs = ((1, 30, 4),) + BURST[:5]
    jsrv, srv = make_servers(arch, **kw)
    eos, cancel_after = None, 0
    if case == "eos-and-cancel":
        _, probe, _ = replay(ContinuousBatchingScheduler, ServeRequest,
                             port_server(arch, jsrv, **kw), VirtualClock(), specs)
        eos = first_new(probe[1]["tokens"][0].tolist())[1]
        cancel_after = 5
    select = "arrival" if case == "arrival-select" else "hol"
    js, jrec, jorder = replay(JaxScheduler, JaxRequest, jsrv, JaxVirtualClock(), specs,
                              cancel_after, eos, select)
    ps, prec, porder = replay(ContinuousBatchingScheduler, ServeRequest, srv, VirtualClock(),
                              specs, cancel_after, eos, select)
    assert porder == jorder
    for i in jrec:
        np.testing.assert_array_equal(prec[i]["tokens"].numpy(), np.asarray(jrec[i]["tokens"]))
        assert tuple(prec[i][f] for f in RECORD_FIELDS) == tuple(jrec[i][f]
                                                                 for f in RECORD_FIELDS)
    assert {k: getattr(ps.metrics, k) for k in SCHED_COUNTERS} == \
        {k: getattr(js.metrics, k) for k in SCHED_COUNTERS}
    assert ps.metrics.ttft_latency.count == js.metrics.ttft_latency.count
    assert srv.pool.metrics.as_dict() == jsrv.pool.metrics.as_dict()
    reasons = [prec[i]["finish_reason"] for i in range(len(specs))]
    if case == "eos-and-cancel":
        assert reasons[1] == "eos" and "cancelled" in reasons
    if case != "arrival-select":
        assert ps.metrics.joins >= 2 and ps.metrics.groups == 1
    else:
        assert prec[0]["bucket"] == (1, 64) and prec[1]["bucket"][1] == 128
        assert ps.metrics.groups == 3


def test_simulated_arrivals_match_reference():
    reqs = [ServeRequest(1, 40) for _ in range(6)]
    jreqs = [JaxRequest(1, 40) for _ in range(6)]
    for rate in (0.0, 25.0):
        assert [t for t, _ in simulate_arrivals(reqs, rate, seed=3)] == \
            [t for t, _ in jax_arrivals(jreqs, rate, seed=3)]


def test_poisson_arrivals_complete_with_sane_counters():
    """Timed arrivals group by how fast the engine runs, so only the port
    runs them; every request completes and the counters add up."""
    _, srv = make_servers("yi-6b-smoke")
    reqs = [ServeRequest(b, c, n) for b, c, n in BURST]
    sched = ContinuousBatchingScheduler(srv)
    res = sched.run(simulate_arrivals(reqs, 200.0, seed=1))
    m = sched.metrics
    assert len(res) == m.admitted == m.completed == len(reqs)
    assert m.batch_slots_used == sum(r.batch for r in reqs) - m.join_rows
    assert all(r["tokens"].shape == (q.batch, q.new_tokens)
               for r, q in zip(sorted(res, key=lambda r: r["rid"]), reqs))
    assert srv.pool.live_bytes() == 0
    assert "scheduler:" in sched.summary() and "kv_pages:" in sched.summary()


# ---------------------------------------------------------------------------
# RequestQueue against the reference's
# ---------------------------------------------------------------------------

_REQS = st.lists(st.tuples(st.integers(1, 6), st.integers(1, 300), st.integers(1, 40)),
                 min_size=1, max_size=20)
_OPS = st.lists(st.tuples(st.sampled_from(["next", "join", "requeue", "remove"]),
                          st.integers(0, 64)), max_size=30)


@settings(max_examples=80, deadline=None, database=None)
@given(reqs=_REQS, ops=_OPS, select=st.sampled_from(["hol", "arrival"]),
       cap=st.integers(1, 8), min_seq=st.sampled_from([16, 64]))
def test_request_queue_matches_reference(reqs, ops, select, cap, min_seq):
    """HOL and arrival bucket selection (with its bounded deferral),
    ``take_joinable`` with a cumulative ``fits`` predicate, ``requeue_front``
    and ``remove``: the same calls on both queues leave the same pending
    requests, in the same order, and return the same groups."""
    port = RequestQueue(BucketPolicy(min_seq=min_seq), cap, select=select)
    ref = JaxQueue(JaxBucketPolicy(min_seq=min_seq), cap, select=select)
    # request index per rid, per queue: the two packages count rids apart
    ids = {port: {}, ref: {}}
    for i, (b, c, n) in enumerate(reqs):
        for q, cls in ((port, ServeRequest), (ref, JaxRequest)):
            r = cls(b, c, n)
            ids[q][r.rid] = i
            q.admit(r, arrival_s=float(i // 3))

    def names(q, qrs):
        return [ids[q][qr.rid] for qr in qrs]

    popped = {port: [], ref: []}
    for op, arg in ops:
        out = {}
        for q in (port, ref):
            if op == "next":
                popped[q] = q.next_group()
                out[q] = names(q, popped[q])
            elif op == "join" and q.pending:
                bucket = q.seq_bucket(q.pending[arg % len(q.pending)].req)
                budget = {"rows": arg % 5 + 1}

                def fits(qr, budget=budget):
                    budget["rows"] -= qr.req.batch
                    return budget["rows"] >= 0

                out[q] = names(q, q.take_joinable(bucket, arg % 9, fits=fits))
            elif op == "requeue":
                q.requeue_front(popped[q])
                popped[q] = []
            elif op == "remove" and q.pending:
                rid = q.pending[arg % len(q.pending)].rid
                out[q] = ids[q][q.remove(rid).rid]
        assert out.get(port) == out.get(ref), op
        assert names(port, port.pending) == names(ref, ref.pending), op


# ---------------------------------------------------------------------------
# the launcher's engine modes
# ---------------------------------------------------------------------------


def _cli(*argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_cli.main(["--arch", "yi-6b-smoke", "--device", "cpu", *argv])
    return buf.getvalue()


def test_cli_single_shot_streams_one_request():
    out = _cli("--batch", "2", "--context", "40", "--tokens", "5")
    assert "# first token after" in out and "# finished: length" in out
    assert "decoded 5 tokens x 2 seqs" in out and "device=cpu" in out
    assert "scheduler: admitted=1 completed=1" in out


def test_cli_scheduler_mode_with_cancel_and_sanitizer():
    out = _cli("--scheduler", "--requests", "10", "--tokens", "6", "--cancel-after", "3",
               "--sanitize", "--shapes", "1x100,2x90,1x60")
    lines = [ln for ln in out.splitlines() if ln.startswith("req[")]
    assert len(lines) == 10 and all("[cancelled]" in ln for ln in lines)
    assert "scheduler: admitted=10 completed=0" in out and "cancelled=10" in out


def test_cli_refuses_replicas_until_the_router_is_ported(capsys):
    """The router is ported: ``--replicas 2`` serves through it, and what
    the CLI still refuses is a replica it does not have."""
    serve_cli.main(["--scheduler", "--replicas", "2", "--requests", "4", "--tokens", "2",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "router: replicas=2" in out and "fleet: scheduler: admitted=4 completed=4" in out
    with pytest.raises(SystemExit, match=r"--drain-replica 2: no such replica \(--replicas 2\)"):
        serve_cli.main(["--scheduler", "--replicas", "2", "--drain-replica", "2",
                        "--device", "cpu"])
