"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b-smoke \\
        --steps 100 --batch 8 --seq 64 --optimizer adam --lr 1e-2 [--device cpu]

The reference's flags and defaults, plus ``--device`` (default ``cuda``;
with no card it raises, it never falls back to the CPU). The plan compiler
picks the execution strategy for one card — remat, optimizer-state dtype,
microbatches — exactly like SystemML picking single-node vs distributed
plans per deployment; its ``explain()`` is printed first. Then seeded
random weights, ``make_batch`` for every step, the plan-driven train step
with a ``StepTimer`` record every ``--log-every`` steps, and with
``--checkpoint`` the parameters saved there. The plan is compiled for the
run's own compute dtype (the reference's launcher sizes it as bfloat16
whatever ``--dtype`` says).

Under ``torchrun`` (``WORLD_SIZE`` > 1) every rank initialises the process
group (``launch/mesh.init_distributed``: NCCL when each rank has a card of
its own, gloo when ranks share a card or run on the CPU) and the mesh is
``MeshConfig((world,), ("data",))``, as the reference builds ``(n_dev,)``;
the planner picks DP or FSDP for it, each rank makes the same seeded
weights and batches and keeps what the plan gives it, and only rank 0
prints and writes the checkpoint (the full arrays, gathered)::

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu
"""

from __future__ import annotations

import argparse
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import InputShape, MeshConfig, ModelConfig, TrainConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.planner import compile_plan
from repro_torch.core.strategies import ExecutionPlan
from repro_torch.data import make_batch
from repro_torch.launch.mesh import init_distributed, make_local_mesh
from repro_torch.models.model import build_model
from repro_torch.runtime.metrics import StepTimer, format_metrics
from repro_torch.runtime.train_loop import (init_opt_state, make_train_step, shard_params,
                                            train_shardings)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TrainRun:
    """What a run leaves: the config, its plan, the trained parameters and
    optimizer state, the step function, and the timer's records."""

    cfg: ModelConfig
    plan: ExecutionPlan
    shape: InputShape
    device: torch.device
    dtype: torch.dtype
    params: Dict[str, torch.Tensor]
    opt_state: Dict
    step_fn: Callable
    timer: StepTimer
    save_s: Optional[float] = None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-6b-smoke",
                    help=f"one of {ARCH_IDS} (append -smoke for reduced)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; fails without a card)")
    return ap


def data_mesh(device: torch.device) -> MeshConfig:
    """The run's mesh: ``(world,)`` over ``("data",)``, starting the process
    group first under ``torchrun`` (``WORLD_SIZE`` > 1)."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        init_distributed(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    return MeshConfig(shape=(world,), axis_names=("data",))


def main(argv=None, params: Optional[Dict[str, torch.Tensor]] = None) -> TrainRun:
    """Parses ``argv`` and trains. ``params``: the initial parameters (on
    ``--device``, in ``--dtype``; full tensors on every rank), updated in
    place on one device; by default the model's seeded initialisation."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to run on the CPU")

    cfg = get_config(args.arch)
    dtype = DTYPES[args.dtype]
    model = build_model(cfg, dtype=dtype)

    mesh_cfg = data_mesh(device)
    lead = mesh_cfg.num_devices == 1 or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    shape = InputShape("cli", args.seq, args.batch, "train")
    train = TrainConfig(optimizer=args.optimizer, learning_rate=args.lr)
    plan = compile_plan(cfg, shape, mesh_cfg, train, dtype=args.dtype)
    say(plan.explain())

    if params is None:
        params = model.init_params(torch.Generator(device=device).manual_seed(0))
    if mesh_cfg.num_devices > 1:
        params = shard_params(params, model, plan.config, mesh_cfg)
    opt = init_opt_state(args.optimizer, params, plan.config)
    step_fn = make_train_step(model, plan.config, mesh_cfg, train)

    timer = StepTimer(model=cfg, shape=shape, mesh=mesh_cfg)
    for i in range(args.steps):
        batch = make_batch(cfg, shape, step=i, dtype=dtype, device=device)
        timer.start()
        params, opt, metrics = step_fn(params, opt, batch, i)
        rec = timer.stop(i, metrics)
        if i % args.log_every == 0 or i == args.steps - 1:
            say(format_metrics(rec), flush=True)

    run = TrainRun(cfg, plan, shape, device, dtype, params, opt, step_fn, timer)
    if args.checkpoint:
        shardings = None
        if mesh_cfg.num_devices > 1:
            (_s, _p, shardings), _o = train_shardings(model, plan.config, mesh_cfg, train,
                                                      make_local_mesh(device))
        t0 = time.perf_counter()
        save_checkpoint(args.checkpoint, params, step=args.steps, shardings=shardings)
        run.save_s = time.perf_counter() - t0
        say(f"saved checkpoint to {args.checkpoint} in {run.save_s:.1f} s")
    summary = timer.summary()
    say("summary:", format_metrics(summary))
    if not math.isfinite(summary.get("loss", 0.0)):
        raise SystemExit(f"loss is not finite: {summary.get('loss')}")
    return run


if __name__ == "__main__":
    main()
