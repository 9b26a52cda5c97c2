"""End-to-end training driver: a transformer LM trained for a few hundred
steps through the full production path (plan compiler -> train step ->
metrics -> checkpoint) — the port's twin of ``examples/train_lm.py``.

The default is a ~5M-parameter model; ``--size 100m`` builds a ~100M one
(the same path). After training it saves a checkpoint, restores it, checks
the restored tensors equal the trained ones, and asserts the loss dropped
by 10 % (which takes the default 200 steps).

    PYTHONPATH=src python -m repro_torch.launch.train_lm [--device cpu]
        [--size 5m] [--steps 200]

Runs on the card unless ``--device`` names another device; the checkpoint
goes to ``build/lm_ckpt`` at the repository root unless ``--checkpoint``
names another directory. Under ``torchrun`` it trains over the ranks as
``launch/train.py`` does (each rank's blocks under the plan; only rank 0
prints; the checkpoint holds the full arrays and each rank restores its
blocks).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.config import InputShape, ModelConfig, TrainConfig
from repro_torch.core.planner import compile_plan
from repro_torch.data import make_batch
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import data_mesh
from repro_torch.models.model import build_model
from repro_torch.runtime.metrics import StepTimer, format_metrics
from repro_torch.runtime.train_loop import (init_opt_state, make_train_step, shard_params,
                                            train_shardings)

SIZES = {
    "5m": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
               head_dim=64, d_ff=768, vocab_size=512),
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 head_dim=64, d_ff=2304, vocab_size=32000),
}
DEFAULT_CHECKPOINT = Path(__file__).resolve().parents[3] / "build" / "lm_ckpt"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", choices=list(SIZES), default="5m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--checkpoint", default=str(DEFAULT_CHECKPOINT))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; fails without a card)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to run on the CPU")

    cfg = ModelConfig(name=f"lm-{args.size}", family="dense",
                      tie_embeddings=False, **SIZES[args.size])
    model = build_model(cfg, dtype=torch.float32)
    mesh_cfg = data_mesh(device)
    lead = mesh_cfg.num_devices == 1 or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"params: {model.param_count() / 1e6:.1f}M")

    shape = InputShape("lm", args.seq, args.batch, "train")
    train = TrainConfig(optimizer="adam", learning_rate=args.lr)
    plan = compile_plan(cfg, shape, mesh_cfg, train, dtype="float32")
    say(plan.explain())

    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    shardings = None
    if mesh_cfg.num_devices > 1:
        params = shard_params(params, model, plan.config, mesh_cfg)
        (_s, _p, shardings), _o = train_shardings(model, plan.config, mesh_cfg, train,
                                                  make_local_mesh(device))
    opt = init_opt_state("adam", params, plan.config)
    step_fn = make_train_step(model, plan.config, mesh_cfg, train)

    timer = StepTimer(model=cfg, shape=shape, mesh=mesh_cfg)
    losses = []
    for i in range(args.steps):
        batch = make_batch(cfg, shape, step=i, dtype=torch.float32, device=device)
        timer.start()
        params, opt, metrics = step_fn(params, opt, batch, i)
        rec = timer.stop(i, metrics)
        losses.append(rec["loss"])
        if i % 20 == 0 or i == args.steps - 1:
            say(format_metrics(rec), flush=True)

    save_checkpoint(args.checkpoint, params, step=args.steps, shardings=shardings)
    restored, step = load_checkpoint(args.checkpoint, params, shardings=shardings)
    if step != args.steps or any(not torch.equal(restored[k], params[k]) for k in params):
        raise SystemExit(f"checkpoint roundtrip failed at step {step}")
    say(f"checkpoint roundtrip OK at step {step}")
    say(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    if not losses[-1] < losses[0] * 0.9:
        raise SystemExit("loss should drop noticeably")
    say("OK")
    return losses


if __name__ == "__main__":
    main()
