"""Serving launcher of the PyTorch port: the sequential request stream.

Requests of varying (batch, context) go one by one through
``PlanServer.handle`` — bucket, arena, row admission, prefill, handoff
write, paged decode — on the GPU unless ``--device`` names another. The
default arch is the reference launcher's, ``mamba2-1.3b-smoke``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b-smoke \\
        --stream --prefill --requests 8 --tokens 4
    PYTHONPATH=src python -m repro_torch.launch.serve --stream --prefill \\
        --shapes 2x100,1x40 --device cpu

The reference's single-shot and ``--scheduler`` modes run through its
serving engine, which this port brings in slice 2.
"""

from __future__ import annotations

import argparse
import random

from repro_torch.configs import get_config
from repro_torch.models.blocks import DECODE_KERNELS
from repro_torch.runtime.engine_config import EngineConfig
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


def serve_stream(args) -> None:
    config = EngineConfig(dtype=args.dtype, seed=args.seed, prefill=args.prefill,
                          page_size=args.page_size, decode_kernel=args.decode_kernel)
    srv = PlanServer(get_config(args.arch), config=config, device=args.device)
    mix = _parse_shapes(args.shapes) if args.shapes else DEFAULT_SHAPE_MIX
    rng = random.Random(args.seed)
    reqs = [ServeRequest(*mix[rng.randrange(len(mix))], args.tokens)
            for _ in range(args.requests)]
    print(f"# stream: {args.arch}, {args.requests} requests over shape mix {mix} on "
          f"{srv.device} ({args.dtype}, page={args.page_size}, "
          f"decode_kernel={args.decode_kernel}, prefill={args.prefill})")
    for i, req in enumerate(reqs):
        out = srv.handle(req)
        n = out["tokens"].shape[1]
        fin = "" if out["finish_reason"] == "length" else f" [{out['finish_reason']}]"
        print(f"req[{i:03d}] batch={req.batch} ctx={req.context} -> "
              f"bucket={out['bucket']} {out['latency_s'] * 1e3:8.1f}ms "
              f"(prefill {out['prefill_s'] * 1e3:.1f}ms, {n} tokens){fin}")
    print(srv.summary())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b-smoke")
    ap.add_argument("--stream", action="store_true",
                    help="serve a mixed-shape request stream via PlanServer")
    ap.add_argument("--prefill", action="store_true",
                    help="full prefill+decode requests with KV-cache handoff")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--shapes", default="",
                    help='request mix as "BxC,BxC,..." (default: built-in mix)')
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--decode-kernel", default="paged",
                    choices=DECODE_KERNELS,
                    help="paged = hand-written CUDA paged-decode kernel (its "
                         "plain version on the CPU); gather = gathered view + "
                         "dense decode attention; ref = the oracle")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds model init and the request mix")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without a card)")
    args = ap.parse_args()
    if not args.stream:
        raise SystemExit("only --stream is ported so far; the single-shot and "
                         "--scheduler modes come with the serving engine in slice 2")
    serve_stream(args)


if __name__ == "__main__":
    main()
