"""Which collectives the gloo backend takes on CUDA tensors, on one card.

    python3 tools/gloo_cuda_probe.py

Two ranks on card 0 join a gloo process group (a file rendezvous under
``build/``) and call each collective that the port's multi-device paths use
(``src/repro_torch/core/comm.py``) on CUDA tensors, float32 and bfloat16:
all_reduce (sum, max), all_gather_into_tensor, reduce_scatter_tensor. One
line per (op, dtype): ``ok`` with the result checked against the expected
values, or the error the backend raised (it catches each op's error to
report it; the port never does). ``core/comm.py`` hands every tensor to
the backend on its own device because this probe found every op taken.
Then each op's time at ``--mib`` MiB a rank (float32; median of 5 after a
warm-up, between barriers): on CUDA tensors directly, on CUDA tensors
copied to the host and back around the op on CPU tensors (staging, which
the port does not do: it was slower), and on CPU tensors alone (the
transport). Ends with the card's name and power limit. Needs the card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]


def _op(name, t, world):
    """The collective ``name`` on ``t`` (its rank's input), as comm.py calls it."""
    if name == "all_reduce":
        dist.all_reduce(t)
    elif name == "all_gather":
        out = torch.empty(world * t.numel(), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t)
    else:
        out = torch.empty(t.numel() // world, dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t)


def _timed(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _timings(rank, world, mib):
    n = mib * 2**20 // 4
    dev = torch.device("cuda", 0)
    x = torch.randn(n, device=dev)
    xc = x.cpu()
    rows = []
    for name in ("all_reduce", "all_gather", "reduce_scatter"):
        direct = _timed(lambda: _op(name, x, world))

        def staged():
            host = x.cpu()
            _op(name, host, world)
            x.copy_(host)

        rows.append((name, direct, _timed(staged), _timed(lambda: _op(name, xc, world))))
    return rows


def _probe(rank: int, world: int, init: str, results, mib: int) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        cases = {
            "all_reduce sum": lambda: _all_reduce(dev, dtype, rank, world, dist.ReduceOp.SUM),
            "all_reduce max": lambda: _all_reduce(dev, dtype, rank, world, dist.ReduceOp.MAX),
            "all_gather_into_tensor": lambda: _all_gather(dev, dtype, rank, world),
            "reduce_scatter_tensor": lambda: _reduce_scatter(dev, dtype, rank, world),
        }
        for name, fn in cases.items():
            try:
                ok = fn()
                out.append((name, str(dtype), "ok" if ok else "WRONG VALUES"))
            except Exception as e:  # the probe reports what the backend refuses
                out.append((name, str(dtype), f"raises {type(e).__name__}: {str(e)[:160]}"))
            dist.barrier()
    results.put((rank, out, _timings(rank, world, mib)))
    dist.destroy_process_group()


def _all_reduce(dev, dtype, rank, world, op) -> bool:
    t = torch.full((1024,), float(rank + 1), dtype=dtype, device=dev)
    dist.all_reduce(t, op=op)
    want = sum(range(1, world + 1)) if op == dist.ReduceOp.SUM else world
    return bool((t.float() == want).all())


def _all_gather(dev, dtype, rank, world) -> bool:
    t = torch.full((1024,), float(rank), dtype=dtype, device=dev)
    out = torch.empty(world * 1024, dtype=dtype, device=dev)
    dist.all_gather_into_tensor(out, t)
    return all(bool((out[r * 1024:(r + 1) * 1024].float() == r).all()) for r in range(world))


def _reduce_scatter(dev, dtype, rank, world) -> bool:
    t = torch.arange(world * 1024, device=dev).to(dtype)
    out = torch.empty(1024, dtype=dtype, device=dev)
    dist.reduce_scatter_tensor(out, t)
    want = torch.arange(rank * 1024, (rank + 1) * 1024, device=dev).to(dtype).float() * world
    return bool((out.float() == want).all())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mib", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device available", file=sys.stderr)
        return 2
    (ROOT / "build").mkdir(exist_ok=True)
    rendezvous = tempfile.mktemp(prefix="gloo_probe_", dir=ROOT / "build")
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    mp.start_processes(_probe, args=(2, f"file://{rendezvous}", results, args.mib), nprocs=2,
                       join=True, start_method="spawn")
    got = {rank: (rows, times) for rank, rows, times in (results.get() for _ in range(2))}
    print(f"gloo on CUDA tensors, 2 ranks on card 0 (torch {torch.__version__}):")
    for (name, dtype, verdict), (_n, _d, other) in zip(got[0][0], got[1][0]):
        print(f"  {name:24s} {dtype:16s} rank 0: {verdict}; rank 1: {other}")
    print(f"time of one call at {args.mib} MiB a rank, float32, ms (rank 0; rank 1):")
    for (name, *t0), (_n, *t1) in zip(got[0][1], got[1][1]):
        print(f"  {name:16s} CUDA direct {t0[0]:.1f}; {t1[0]:.1f}   CUDA staged through the "
              f"host {t0[1]:.1f}; {t1[1]:.1f}   CPU tensors {t0[2]:.1f}; {t1[2]:.1f}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
