"""Paged decode kernel of one source tree, timed on the card at the Yi-6B
serving path's two decode shapes, for comparing two trees in one run.

    python3 tools/paged_decode_ab.py [--tree DIR] [--label NAME] [--flush-modes ...]

``--tree`` is the root of a checkout of this repository (default: this
one); its ``src/repro_torch`` is imported, and its kernels are built into
its own ``build/`` directory. The measuring code is this checkout's
(``chip_smoke.py``): bfloat16 inputs from a fixed seed, the result held
against the float32 plain version under ``PAGED_BF16_TOL``, then the CUDA-
event median of 20 calls and the profiler device time per call of the
paged kernels, the L2 flushed before every call. One JSON line per shape.
Run trees in turns, one process each (parent, change, change, parent), to
compare them on one card.

The flush is ``chip_smoke.py``'s (96 MB of zeros written, which leaves the
L2 full of dirty lines that the kernel's reads must write back first);
``--flush-modes write read none`` adds the device time after a flush that
only reads 96 MB (a clean L2 without the call's data, closer to a decode
step, where the layer's weights were read before the call) and with no
flush at all (the call's K/V, 33 MB at the serving shape, warm in the 50 MB
L2).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
# (label, batch, Sc, positions): the (8, 2000) request mid-decode in its
# (8, 2048) bucket and the (1, 512) request in its (1, 1024) bucket; Yi-6B
# widths (Hq 32, Hkv 4, D 128), page 64
SHAPES = (("serving (8, 2048)", 8, 2048, [2000 + 4 * i for i in range(8)]),
          ("bucket (1, 1024)", 1, 1024, [527]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--label", default=None)
    ap.add_argument("--flush-modes", nargs="+", default=["write"],
                    choices=("write", "read", "none"))
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    # the tree's own chip_smoke.py and sources, chosen here at run time
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(tree))
    if not torch.cuda.is_available():
        print("paged_decode_ab: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as CS  # lint: allow-local-import
    from repro_torch.kernels import paged_attention as PA  # lint: allow-local-import

    if not Path(PA.__file__).resolve().is_relative_to(tree):
        print(f"paged_decode_ab: imported {PA.__file__}, not from {tree}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    reader = torch.zeros(24 << 20, dtype=torch.float32, device="cuda")   # 96 MB

    class ReadFlush:
        """Stands in for the flush buffer: ``zero_()`` reads 96 MB instead."""

        def zero_(self):
            reader.sum()

    flushes = {"write": flush, "read": ReadFlush(), "none": None}
    hq, hkv, d, page = 32, 4, 128, 64
    for label, b, sc, pos in SHAPES:
        q, k, v, tables, posv = CS._paged_inputs(b, hq, hkv, d, page, sc, pos,
                                                 torch.bfloat16, 4)

        def call():
            return PA.paged_decode_attention(q, k, v, tables, posv, page=page, sc=sc)

        got = call()
        want = PA.paged_attention_torch(q.float(), k.float(), v.float(), tables, posv,
                                        page=page, sc=sc)
        ok, max_err, _, rms_ratio = CS.within(got, want, CS.PAGED_BF16_TOL)
        ms = CS.cuda_ms(call, flush=flush)
        dev_ms, names = CS.device_ms(call, "paged_decode", flush)
        by_flush = {mode: CS.device_ms(call, "paged_decode", flushes[mode])[0]
                    for mode in args.flush_modes}
        slots = sum(min(p + 1, sc) for p in pos)
        nbytes = slots * hkv * d * 2 * 2 + 2 * b * hq * d * 2 + tables.numel() * 4 + b * 4
        bound, _ = CS._bound_ms(nbytes, 4 * hq * d * slots, torch.bfloat16)
        print(json.dumps({"tree": args.label or str(tree), "shape": label, "ok": ok,
                          "max_abs_err": max_err, "err_rms_ratio": rms_ratio,
                          "event_ms": ms, "device_ms": dev_ms,
                          "device_ms_by_flush": by_flush,
                          "kernels": {CS._short(n): t for n, t in names.items()},
                          "bound_ms": bound, "card": smi}), flush=True)
        if not ok:
            print(f"paged_decode_ab: {label} disagrees with the plain version",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
