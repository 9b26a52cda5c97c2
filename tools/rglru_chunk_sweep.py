"""Device time of the RG-LRU scan kernel at each chunks-per-block setting.

    python3 tools/rglru_chunk_sweep.py [--shapes 8x2048 1x4096 ...]

For recurrentgemma-2b's prompt shapes (bfloat16, W = 2560; by default the
(8, 2048), (4, 2048), (1, 4096) and (1, 1024) buckets of ``chip_smoke.py``
phase 11) it times ``kernels.rglru_scan.rglru_scan`` with 1, 2, 4, 8, 16
and 32 chunks of 8 positions a block by profiler device time, the L2
flushed before every call (``chip_smoke.py``'s ``device_ms``), checks each
setting's output against the plain version, and marks the one that
``chunk_plan`` picks for the card. Needs the card (builds the kernels with
nvcc); exits non-zero if a setting disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.hw import sm_count  # noqa: E402
from repro_torch.kernels import rglru_scan as RG  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="*", default=["8x2048", "4x2048", "1x4096", "1x1024"],
                    help="BxS prompt shapes at W = 2560")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rglru_chunk_sweep: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    sms = sm_count(torch.device("cuda"))
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    bad = False
    for text in args.shapes:
        b, s = (int(v) for v in text.split("x"))
        inputs = cs._rglru_inputs(b, s, 2560, torch.bfloat16, 21)
        want_y, want_h = RG.rglru_scan_torch(*inputs, out_dtype=torch.float32)
        plan = RG.chunk_plan(b, s, 2560, sms)[1]
        row = []
        for chunks in (1, 2, 4, 8, 16, 32):
            y, h = RG.rglru_scan(*inputs, chunks=chunks)
            torch.cuda.synchronize()
            ok = (cs.within(y, want_y, cs.RGLRU_BF16_TOL)[0]
                  and cs.within(h, want_h, cs.FP32_TOL)[0])
            bad |= not ok
            dev, _ = cs.device_ms(lambda: RG.rglru_scan(*inputs, chunks=chunks), "rglru", flush)
            row.append(f"{chunks}{' (plan)' if chunks == plan else ''} {cs._dev(dev)}"
                       f"{'' if ok else ' MISMATCH'}")
        print(f"rglru_scan bfloat16 ({b}, {s}, 2560), device time by chunks a block: "
              + "; ".join(row), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
