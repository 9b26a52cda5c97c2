"""A replica fleet behind the one ``EngineClient`` API — the port's twin of
``examples/serve_router.py``:

1. **placement** — each submitted request is routed to one of N engine
   replicas by bucket affinity (join an in-flight same-bucket group, else
   an idle replica, else the replica whose plan cache already holds the
   bucket); every decision is recorded with its reason;
2. **one client surface** — the same ``submit`` / ``stream`` / ``drain``
   consumption code runs unchanged against a bare engine
   (``EngineConfig(replicas=1).build_client(...)``) or a fleet;
3. **drain / failover** — a replica leaves mid-decode and its in-flight
   requests finish on the survivors, token streams intact.

    PYTHONPATH=src python -m repro_torch.launch.serve_router [--device cpu]
        [--arch yi-6b-smoke] [--replicas 2]

Runs on the card unless ``--device`` names another device; the replicas
share one copy of the weights there.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.runtime.engine_config import EngineConfig
from repro_torch.runtime.serve_loop import ServeRequest


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-6b-smoke")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without a card)")
    args = ap.parse_args(argv)
    if args.replicas < 2:
        raise SystemExit(f"--replicas {args.replicas}: a fleet to drain needs 2 or more")

    cfg = EngineConfig(replicas=args.replicas)
    router = cfg.build_client(get_config(args.arch), device=args.device)

    # --- 1. placement: a burst of mixed-shape requests spreads across the
    # fleet; same-bucket requests land where they can coalesce
    handles = [router.submit(ServeRequest(1, 40 + 8 * (i % 3), 8)) for i in range(6)]
    for d in router.decisions:
        print(f"rid={d.rid} -> replica[{d.replica}] ({d.reason})")

    # --- 2. the EngineClient surface: stream a few of one request's tokens
    # while the rest of the fleet keeps decoding underneath (the
    # consumption code is identical against a bare engine)
    print("rid", handles[0].rid, "streams:", end=" ")
    for ev in handles[0].stream():
        if ev.token is not None:
            print(int(ev.token[0, 0]), end=" ", flush=True)
            if ev.index >= 3:
                print("...")
                break

    # --- 3. drain / failover: take replica 1 out while it still holds live
    # mid-decode work — everything finishes on the survivors
    live_on_1 = [h.rid for h in router.handles.values()
                 if h.replica is not None and h.replica.idx == 1 and not h.done]
    moved = router.drain_replica(1)
    print(f"drained replica 1 (live: {live_on_1}); resubmitted {[h.rid for h in moved]} "
          f"to survivors")
    router.drain()
    done = sorted(h.rid for h in handles if h.done)
    print(f"all {len(done)} requests completed: {done}")
    print(router.summary())


if __name__ == "__main__":
    main()
