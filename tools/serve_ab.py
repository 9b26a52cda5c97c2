"""``PlanServer.handle`` of one source tree on the card: full Yi-6B,
Mamba-2 1.3B and RecurrentGemma-2B (bfloat16, page 64,
``decode_kernel="auto"``, weights random from ``chip_smoke.SEED``) serving
``chip_smoke.SERVE_REQUESTS`` (RecurrentGemma:
``chip_smoke.HYBRID_SERVE_REQUESTS``, as phase 11) with 32 new tokens
each, ``1 + --steady`` times (the first pass compiles the plans and
captures the decode graphs, the rest are the steady state), for comparing
two trees in one run.

    python3 tools/serve_ab.py [--tree DIR] [--label NAME] [--steady N]
                              [--models yi-6b mamba2-1.3b recurrentgemma-2b]

``--tree`` is the root of a checkout of this repository (default: this
one); its ``src/repro_torch`` and its ``chip_smoke.py`` are imported, and its kernels are built into
its own ``build/`` directory. One JSON line per model and pass: per request
the prefill ms, the decode ms per step (host clock around the request's
decode, which ends after the device has finished it) and the total ms, with
the card's name and power limit. Run trees in turns, one process each
(parent, change, change, parent), to compare them on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--label", default=None)
    ap.add_argument("--steady", type=int, default=3)
    ap.add_argument("--models", nargs="+",
                    default=["yi-6b", "mamba2-1.3b", "recurrentgemma-2b"])
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    # the tree's own chip_smoke.py and sources, chosen here at run time
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(tree))
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as CS  # lint: allow-local-import
    from repro_torch.configs import get_config  # lint: allow-local-import
    from repro_torch.runtime import serve_loop  # lint: allow-local-import
    from repro_torch.runtime.engine_config import EngineConfig  # lint: allow-local-import

    if not Path(serve_loop.__file__).resolve().is_relative_to(tree):
        print(f"serve_ab: imported {serve_loop.__file__}, not from {tree}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    for arch in args.models:
        cfg = get_config(arch)
        # the hybrid family's phase 11 adds a (1, 3000) request
        requests = CS.HYBRID_SERVE_REQUESTS if cfg.family == "hybrid" else CS.SERVE_REQUESTS
        srv = serve_loop.PlanServer(cfg, config=EngineConfig(
            dtype="bfloat16", prefill=True, page_size=64, decode_kernel="auto", seed=CS.SEED))
        srv.handle(serve_loop.ServeRequest(1, 16, new_tokens=2))    # warm-up
        for name in ["capture"] + [f"steady{i}" for i in range(1, args.steady + 1)]:
            outs = [srv.handle(serve_loop.ServeRequest(b, c, new_tokens=32))
                    for b, c in requests]
            print(json.dumps({
                "label": args.label or str(tree), "arch": arch, "pass": name, "card": smi,
                "requests": [{"shape": f"{b}x{c}",
                              "prefill_ms": round(o["prefill_s"] * 1e3, 3),
                              "decode_ms_per_step": round(
                                  o["decode_s"] * 1e3 / max(1, o["decode_steps"]), 3),
                              "decode_steps": o["decode_steps"],
                              "total_ms": round(o["latency_s"] * 1e3, 3)}
                             for (b, c), o in zip(requests, outs)]}), flush=True)
        del srv, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
