"""Serving launcher of the PyTorch port: every mode is one ``EngineClient``
behind one ``EngineConfig`` (port of ``repro/launch/serve.py``), on the GPU
unless ``--device`` names another, and ``--replicas N`` swaps the bare
engine for an ``EngineRouter`` over N replicas without changing anything
else. The default arch is the reference launcher's, ``mamba2-1.3b-smoke``.

Single-shot mode (streams the one request's tokens as they decode):

    PYTHONPATH=src python -m repro_torch.launch.serve --batch 4 --context 128 \\
        --tokens 32 --device cpu

Mixed-shape request-stream mode — the sequential front door
(``PlanServer.handle``, a submit-and-drain engine adapter): requests of
varying (batch, context) round up to power-of-two buckets, steady-state
requests hit cached plans (and, on the card, replay their bucket's decode
graph), and estimate breaches trigger recompilation:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b-smoke \\
        --stream --prefill --requests 8 --tokens 4
    PYTHONPATH=src python -m repro_torch.launch.serve --stream --prefill \\
        --shapes 2x100,1x40 --device cpu

Continuous-batching mode — the engine driven with simulated arrivals:
pending requests coalesce into shared shape buckets, prefill populates each
request's KV-cache pool rows, and ``--join-mid-decode`` (default on) absorbs
newly arrived same-bucket requests into free rows of in-flight groups
between decode steps. ``--eos-id`` stamps an end-of-sequence stop condition
on every request, ``--cancel-after N`` cancels each request after its N-th
streamed token; both release the request's rows and pages the same tick:

    PYTHONPATH=src python -m repro_torch.launch.serve --scheduler \\
        --requests 24 --arrival-rate 20 --slo-ms 2000
    PYTHONPATH=src python -m repro_torch.launch.serve --scheduler \\
        --requests 24 --eos-id 450 --cancel-after 6 --sanitize --device cpu

Multi-replica fleet mode — the same scheduler front door over an
``EngineRouter``: requests are placed across replicas (bucket affinity by
default, ``--placement load`` for queue-pressure ranking), and
``--drain-replica N`` takes replica N out mid-run (its in-flight requests
finish on the survivors, token streams intact). The replicas share one copy
of the weights on the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --scheduler --replicas 2 \\
        --requests 24 --arrival-rate 50
    PYTHONPATH=src python -m repro_torch.launch.serve --scheduler --replicas 2 \\
        --requests 12 --drain-replica 1 --sanitize --device cpu
"""

from __future__ import annotations

import argparse
import random

from repro_torch.configs import get_config
from repro_torch.models.blocks import DECODE_KERNELS
from repro_torch.runtime.engine_config import EngineConfig
from repro_torch.runtime.scheduler import simulate_arrivals
from repro_torch.runtime.serve_loop import PlanServer, ServeRequest

DEFAULT_SHAPE_MIX = ((1, 40), (2, 100), (4, 60), (1, 200), (2, 250))


def _parse_shapes(spec: str):
    """``"2x100,1x40"`` -> ((2, 100), (1, 40))."""
    out = []
    for part in spec.split(","):
        try:
            b, c = part.lower().split("x")
            out.append((int(b), int(c)))
        except ValueError:
            raise SystemExit(f"--shapes: bad entry {part!r} (expected BATCHxCONTEXT, "
                             f'e.g. "2x100,1x40")')
    return tuple(out)


def _build_server(args) -> PlanServer:
    # every flag folds into the one EngineConfig; the seed covers model
    # init, the request mix and arrivals, so runs are reproducible
    return EngineConfig.from_args(args).build_server(get_config(args.arch),
                                                     device=args.device)


def _request_mix(args):
    mix = _parse_shapes(args.shapes) if args.shapes else DEFAULT_SHAPE_MIX
    rng = random.Random(args.seed)
    return mix, [ServeRequest(*mix[rng.randrange(len(mix))], args.tokens,
                              eos_id=args.eos_id)
                 for _ in range(args.requests)]


def serve_stream(args) -> None:
    """Sequential front door: one submit-and-drain engine pass per request
    (the plan cache + dynamic recompilation A/B harness)."""
    srv = _build_server(args)
    mix, reqs = _request_mix(args)
    print(f"# stream: {args.arch}, {args.requests} requests over shape mix {mix} on "
          f"{srv.device} ({args.dtype}, page={args.page_size}, "
          f"decode_kernel={args.decode_kernel}, prefill={args.prefill}, "
          f"cache={'off' if args.no_cache else args.cache_capacity})")
    for i, req in enumerate(reqs):
        out = srv.handle(req)
        n = out["tokens"].shape[1]
        fin = "" if out["finish_reason"] == "length" else f" [{out['finish_reason']}]"
        flag = "  RECOMPILED: " + "; ".join(out["recompile_reasons"]) if out["recompiled"] else ""
        print(f"req[{i:03d}] batch={req.batch} ctx={req.context} -> "
              f"bucket={out['bucket']} {out['latency_s'] * 1e3:8.1f}ms "
              f"(prefill {out['prefill_s'] * 1e3:.1f}ms, {n} tokens, decode kernel "
              f"{out['plan'].explain_axes()['decode_kernel']}){fin}{flag}")
    print(srv.summary())


def serve_scheduled(args) -> None:
    """Continuous-batching mode, written once against the ``EngineClient``
    protocol: a bare engine for ``--replicas 1``, an ``EngineRouter`` for
    more. Arrivals in (Poisson at ``--arrival-rate``, a closed burst at 0),
    token events out, cancelling mid-decode when ``--cancel-after`` says the
    client hung up, draining a replica mid-run when ``--drain-replica`` says
    it is going away."""
    cfg = EngineConfig.from_args(args)
    if args.drain_replica is not None and not 0 <= args.drain_replica < cfg.replicas:
        raise SystemExit(f"--drain-replica {args.drain_replica}: no such replica "
                         f"(--replicas {cfg.replicas})")
    client = cfg.build_client(get_config(args.arch), device=args.device)
    server = client.replicas[0].server if cfg.replicas > 1 else client.server
    mix, reqs = _request_mix(args)
    arrivals = simulate_arrivals(reqs, args.arrival_rate, seed=args.seed)
    print(f"# scheduler: {args.arch}, {args.requests} requests over shape mix {mix} on "
          f"{server.device} arrival_rate={args.arrival_rate}/s replicas={cfg.replicas} "
          f"placement={cfg.placement} max_group_batch={cfg.max_group_batch} "
          f"join_mid_decode={cfg.join_mid_decode} bucket_select={cfg.bucket_select} "
          f"eos_id={args.eos_id} cancel_after={args.cancel_after} sanitize={cfg.sanitize}")
    drain_pending = args.drain_replica is not None

    def on_event(ev):
        nonlocal drain_pending
        if (drain_pending and ev.token is not None and ev.index >= 1
                and any(h.replica is not None and h.replica.idx == args.drain_replica
                        for h in client.handles.values())):
            moved = client.drain_replica(args.drain_replica)
            print(f"# drained replica {args.drain_replica}; resubmitted "
                  f"{[h.rid for h in moved]} to survivors")
            drain_pending = False
        if (args.cancel_after and ev.token is not None
                and ev.index + 1 >= args.cancel_after):
            handle = client.handles.get(ev.rid)
            if handle is not None:
                client.cancel(handle)

    need_hook = bool(args.cancel_after) or drain_pending
    client.run(arrivals, on_event=on_event if need_hook else None)
    for rec in client.results:
        joined = f" joined@{rec['joined_at_step']}" if rec["joined_at_step"] > 0 else ""
        fin = "" if rec["finish_reason"] == "length" else f" [{rec['finish_reason']}]"
        print(f"req[{rec['rid']:03d}] batch={rec['batch']} ctx={rec['context']} -> "
              f"bucket={rec['bucket']} group={rec['group_size']}{joined} "
              f"tokens={rec['tokens'].shape[1]}{fin} "
              f"queue={rec['queue_s'] * 1e3:7.1f}ms exec={rec['exec_s'] * 1e3:7.1f}ms")
    print(client.summary())


def serve_once(args) -> None:
    """Single-shot mode: one request submitted into the engine, its tokens
    printed as the event stream produces them."""
    cfg = EngineConfig.from_args(args)
    eng = cfg.build_engine(cfg.build_server(get_config(args.arch), device=args.device))
    req = ServeRequest(args.batch, args.context, args.tokens, eos_id=args.eos_id)
    handle = eng.submit(req)
    t_first = None
    for ev in handle.stream():
        if ev.token is None:
            print(f"\n# finished: {ev.finish_reason}")
            break
        if t_first is None:
            t_first = ev.t
            print(f"# first token after {t_first * 1e3:.1f}ms")
        print(f"{int(ev.token[0, 0])}", end=" ", flush=True)
    rec = handle.result
    dt = max(1e-9, rec["exec_s"])
    n = rec["tokens"].shape[1]
    print(f"decoded {n} tokens x {req.batch} seqs in {dt:.2f}s "
          f"= {n * req.batch / dt:.1f} tok/s (bucket={rec['bucket']}, "
          f"device={eng.server.device})")
    print(eng.summary())


def build_parser() -> argparse.ArgumentParser:
    """The launcher's command line; its flags and defaults are the reference
    launcher's (``repro/launch/serve.py``) where the option exists there."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    # mixed-shape request-stream mode (plan cache + dynamic recompilation)
    ap.add_argument("--stream", action="store_true",
                    help="serve a mixed-shape request stream via PlanServer")
    ap.add_argument("--requests", type=int, default=16,
                    help="stream and scheduler modes: number of requests")
    ap.add_argument("--shapes", default="",
                    help='request mix as "BxC,BxC,..." (default: built-in mix)')
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the plan cache (A/B baseline): every request "
                         "compiles its plan and builds its step anew")
    ap.add_argument("--prefill", action="store_true",
                    help="stream mode: full prefill+decode requests with KV-cache "
                         "handoff (single-shot and scheduler modes always prefill)")
    ap.add_argument("--cache-capacity", type=int, default=16)
    ap.add_argument("--pool-arenas", type=int, default=4,
                    help="KV-cache pool arenas the compile-time memory "
                         "statistics are provisioned for (pool growth past "
                         "them triggers dynamic recompilation)")
    ap.add_argument("--pool-max-arenas", type=int, default=0,
                    help="hard KV-cache pool budget in arenas (0 = unbounded); a "
                         "full pool queues new groups while mid-decode joins keep "
                         "absorbing work")
    ap.add_argument("--pool-max-bytes", type=float, default=0.0,
                    help="hard KV-cache pool budget in bytes (0 = unbounded); with "
                         "paged arenas the budget charges page-exact committed bytes")
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--decode-kernel", default="auto", dest="decode_kernel",
                    choices=("auto",) + DECODE_KERNELS,
                    help="auto = the planner picks per bucket from the analytic "
                         "cost terms; paged = hand-written CUDA paged-decode "
                         "kernel (its plain version on the CPU); gather = "
                         "gathered view + dense decode attention; ref = the oracle")
    ap.add_argument("--recompile-margin", type=float, default=0.25,
                    help="dynamic-recompilation watermark margin")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds model init, the request mix and arrivals")
    # continuous-batching scheduler mode
    ap.add_argument("--scheduler", action="store_true",
                    help="coalesce requests into shared shape buckets "
                         "(continuous batching) instead of serving one by one")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="scheduler mode: Poisson arrivals per second "
                         "(0 = closed burst, everything arrives at t=0)")
    ap.add_argument("--max-group-batch", type=int, default=8,
                    help="batch-row capacity per group")
    ap.add_argument("--join-mid-decode", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="absorb newly arrived same-bucket requests into free "
                         "cache-pool rows of in-flight groups between decode "
                         "steps; --no-join-mid-decode keeps admission-time "
                         "coalescing only")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="per-request latency objective (0 disables SLO accounting)")
    ap.add_argument("--bucket-select", default="hol", choices=("hol", "arrival"),
                    help="queue bucket policy: strict head-of-line (hol) or "
                         "arrival-aware (the pending bucket with the most "
                         "coalescable rows forms first, with bounded deferral "
                         "of the head bucket)")
    # multi-replica fleet (EngineRouter)
    ap.add_argument("--replicas", type=int, default=1,
                    help="scheduler mode: serve through an EngineRouter over N engine "
                         "replicas sharing one copy of the weights (1 = bare engine; "
                         "both present the same EngineClient API)")
    ap.add_argument("--placement", default="affinity", choices=("affinity", "load"),
                    help="router placement policy: deterministic bucket/plan-cache "
                         "affinity, or adaptive queue-pressure + observed-TTFT ranking")
    ap.add_argument("--drain-replica", type=int, default=None, metavar="N",
                    help="fleet mode: drain replica N once it holds streaming work "
                         "(after a token of index 1 or more); its in-flight requests "
                         "finish on the survivors (failover)")
    # request-lifecycle knobs (engine stop conditions + cancellation)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stamp an end-of-sequence stop condition on every "
                         "request: a row stops at its first eos token and its "
                         "cache rows/pages free the same tick")
    ap.add_argument("--cancel-after", type=int, default=0,
                    help="scheduler mode: cancel each request after its N-th "
                         "streamed token (simulated client disconnect; 0 disables)")
    ap.add_argument("--sanitize", action="store_true",
                    help="runtime sanitizer: re-derive pool/page/handle "
                         "invariants from scratch after every tick and fail "
                         "on the first drift")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without a card)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.scheduler:
        serve_scheduled(args)
    elif args.stream:
        serve_stream(args)
    else:
        serve_once(args)


if __name__ == "__main__":
    main()
