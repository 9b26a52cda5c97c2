"""Runs a function on the ranks of one process group, each rank a process.

    results = run_ranks(fn, world, work, device, *args)

:func:`run_ranks` pickles ``args`` into the directory ``work`` and starts
``world`` processes (``python -m repro_torch.launch.ranks``). Each joins the
default process group through a file rendezvous in ``work`` (no TCP port,
so several groups can run at once on one host) with
``launch/mesh.init_distributed`` on ``device`` (gloo on the CPU and for
ranks that share a card, NCCL when each rank has a card of its own), calls
``fn(rank, world, *args)`` and pickles its return value back. CPU ranks
take one thread each, so that ``world`` of them do not oversubscribe the
host. Each rank's output goes to ``work/rank{r}.log``.

``fn`` is a module-level function of a module that the ranks can import
by name: one under ``src/``, or a top-level module, whose directory goes
on the ranks' ``PYTHONPATH`` (a script such as ``chip_smoke.py`` is
imported as its module, not run as ``__main__``).

The run fails, with the tail of the failing rank's log, if a rank exits
non-zero, gives no result, or is still running after ``timeout`` seconds;
every rank still running then is killed. Nothing is caught and retried.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import init_distributed

SRC = Path(__file__).resolve().parents[2]


def _target(fn: Callable):
    """(module name, directory that holds its top-level package)."""
    path = Path(sys.modules[fn.__module__].__file__).resolve()
    if fn.__module__ == "__main__":
        return path.stem, path.parent
    return fn.__module__, path.parents[fn.__module__.count(".")]


def _tail(path: Path, n: int = 6000) -> str:
    return path.read_text(errors="replace")[-n:] if path.exists() else "(no output)"


def run_ranks(fn: Callable, world: int, work, device: str, *args,
              timeout: float = 600.0) -> List:
    """``[fn(rank, world, *args) for rank in range(world)]``, each rank in a
    process of its own inside one process group on ``device`` ("cpu" or
    "cuda"). ``work`` must be a new or empty directory."""
    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    module, root = _target(fn)
    with open(work / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    paths = [str(SRC), str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(
        os.pathsep) if p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(paths))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    logs = [work / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.ranks", module, fn.__name__, str(r),
                 str(world), str(work), device],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.perf_counter() + timeout
    try:
        while any(p.poll() is None for p in procs):
            for r, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    raise RuntimeError(f"{fn.__name__}: rank {r} exited {p.returncode}\n"
                                       f"{_tail(logs[r])}")
            if time.perf_counter() > deadline:
                raise RuntimeError(f"{fn.__name__}: ranks still running after {timeout} s\n"
                                   f"{_tail(logs[0])}")
            time.sleep(0.1)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"{fn.__name__}: rank {r} exited {p.returncode}\n"
                                   f"{_tail(logs[r])}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r in range(world):
        path = work / f"out{r}.pkl"
        if not path.exists():
            raise RuntimeError(f"{fn.__name__}: rank {r} gave no result\n{_tail(logs[r])}")
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def _rank(module: str, name: str, rank: int, world: int, work: Path, device: str) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    elif not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: no CUDA device")
    fn = getattr(importlib.import_module(module), name)
    with open(work / "args.pkl", "rb") as f:
        args = pickle.load(f)
    init_distributed(device, init_method=f"file://{work / 'rendezvous'}", rank=rank,
                     world_size=world)
    try:
        out = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(work / f"out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    _rank(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), Path(sys.argv[5]),
          sys.argv[6])
