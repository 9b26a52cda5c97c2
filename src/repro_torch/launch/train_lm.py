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
names another directory.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.config import InputShape, MeshConfig, ModelConfig, TrainConfig
from repro_torch.core.planner import compile_plan
from repro_torch.data import make_batch
from repro_torch.models.model import build_model
from repro_torch.runtime.metrics import StepTimer, format_metrics
from repro_torch.runtime.train_loop import init_opt_state, make_train_step

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
    print(f"params: {model.param_count() / 1e6:.1f}M")

    mesh_cfg = MeshConfig(shape=(1,), axis_names=("data",))
    shape = InputShape("lm", args.seq, args.batch, "train")
    train = TrainConfig(optimizer="adam", learning_rate=args.lr)
    plan = compile_plan(cfg, shape, mesh_cfg, train, dtype="float32")
    print(plan.explain())

    params = model.init_params(torch.Generator(device=device).manual_seed(0))
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
            print(format_metrics(rec), flush=True)

    save_checkpoint(args.checkpoint, params, step=args.steps)
    restored, step = load_checkpoint(args.checkpoint, params)
    if step != args.steps or any(not torch.equal(restored[k], params[k]) for k in params):
        raise SystemExit(f"checkpoint roundtrip failed at step {step}")
    print(f"checkpoint roundtrip OK at step {step}")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    if not losses[-1] < losses[0] * 0.9:
        raise SystemExit("loss should drop noticeably")
    print("OK")
    return losses


if __name__ == "__main__":
    main()
