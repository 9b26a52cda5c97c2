"""The serving engine driven directly, through its one request-lifecycle
API — the port's twin of ``examples/serve_engine.py``:

1. **online submission** — requests enter a *live* engine at any time (no
   pre-sorted arrival trace); late arrivals join in-flight groups
   mid-decode;
2. **token streaming** — per-token events as they are produced, instead of
   whole outputs at completion;
3. **early termination** — cancellation and EOS stop conditions free a
   request's cache rows and pages the same tick, making room for others.

    PYTHONPATH=src python -m repro_torch.launch.serve_engine [--device cpu]
        [--arch yi-6b-smoke]

Runs on the card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.runtime.engine_config import EngineConfig
from repro_torch.runtime.serve_loop import ServeRequest


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-6b-smoke")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without a card)")
    args = ap.parse_args(argv)

    cfg = EngineConfig(cache_capacity=16)
    srv = cfg.build_server(get_config(args.arch), device=args.device)
    eng = cfg.build_engine(srv)

    # --- 1. online submission: no trace, just submit into the live engine
    a = eng.submit(ServeRequest(batch=5, context=100, new_tokens=12))
    eng.step()                                     # a's group is in flight
    b = eng.submit(ServeRequest(batch=1, context=90, new_tokens=4))
    # b arrived mid-decode; the engine seats it in a free row of a's group

    # --- 2. streaming: consume b's tokens as they are produced
    print("b streams:", end=" ")
    for ev in b.stream():
        if ev.token is not None:
            print(int(ev.token[0, 0]), end=" ", flush=True)
        else:
            print(f"<{ev.finish_reason}>")
    print(f"b joined a's group at decode step {b.result['joined_at_step']}")

    # --- 3. early termination: the client for `a` hangs up
    eng.cancel(a)
    print(f"a cancelled after {a.result['tokens'].shape[1]} tokens; "
          f"pool reclaimed {srv.pool.metrics.pages_reclaimed} pages")

    # an EOS-stopped request: ends at its first end-of-sequence token
    c = eng.submit(ServeRequest(batch=1, context=60, new_tokens=32, eos_id=450))
    eng.drain()
    print(f"c finished '{c.result['finish_reason']}' with "
          f"{c.result['tokens'].shape[1]}/32 tokens on {srv.device}")
    print(eng.summary())


if __name__ == "__main__":
    main()
