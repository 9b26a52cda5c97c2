"""Loss over a few steps of full-model training at two random
initialisations and several optimizer settings, on the card.

    python3 tools/train_init_sweep.py [--arch yi-6b] [--steps 8]
        [--embed-scales K ...]

A full model (Yi-6B by default; ``--arch recurrentgemma-2b`` or
``mamba2-1.3b``), bfloat16, (4, 2048) batches of the synthetic corpus
(``make_batch``), the plan the port's planner compiles for one H100,
``make_train_step`` with Adam or SGD at a given lr, clipped at 1.0 or not.
Each setting starts from fresh seeded weights: the model's own
initialisation (``Model.init_params``) or ``chip_smoke.trainable_params``
(the attention projections at their true fan-in). ``--embed-scales``
runs instead ``trainable_params`` with the embedding multiplied by each
K, under Adam at 3e-4 clipped at 1.0 (the train phases' setting). One line
per setting: the losses, the global gradient norms (0 where nothing is
clipped), and whether the mean of the last three losses is below step 0's
and below ln(vocab), the loss of uniform logits, with the card's name and
power limit. Needs the card.
"""

from __future__ import annotations

import argparse
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.config import InputShape, MeshConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.planner import compile_plan  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.train_loop import init_opt_state, make_train_step  # noqa: E402

# (initialisation, optimizer, lr, grad_clip)
SETTINGS = (("model", "adam", 3e-4, 1.0), ("model", "adam", 1e-3, 1.0),
            ("model", "adam", 3e-4, 0.0), ("model", "sgd", 1e-2, 1.0),
            ("trainable", "adam", 1e-4, 1.0), ("trainable", "adam", 3e-4, 1.0),
            ("trainable", "adam", 1e-3, 1.0))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--embed-scales", type=float, nargs="+", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_init_sweep: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    model = build_model(cfg, dtype=torch.bfloat16)
    shape = InputShape("cli", 2048, 4, "train")
    mesh = MeshConfig((1,), ("data",))
    plan = compile_plan(cfg, shape, mesh, TrainConfig()).config
    settings = (SETTINGS if args.embed_scales is None else
                [(f"trainable, embedding x {k:g}", "adam", 3e-4, 1.0) for k in args.embed_scales])
    scales = dict(zip((s[0] for s in settings), args.embed_scales or ()))
    uniform = math.log(cfg.vocab_size)
    for init, opt, lr, clip in settings:
        params = (model.init_params(torch.Generator(device="cuda").manual_seed(cs.SEED))
                  if init == "model" else
                  cs.trainable_params(model, cs.SEED, embed_scale=scales.get(init, 1.0)))
        state = init_opt_state(opt, params, plan)
        step = make_train_step(model, plan, mesh, TrainConfig(optimizer=opt, learning_rate=lr,
                                                              grad_clip=clip))
        losses, norms = [], []
        for i in range(args.steps):
            batch = make_batch(cfg, shape, step=i, dtype=torch.bfloat16, device="cuda")
            params, state, met = step(params, state, batch, i)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        last = statistics.mean(losses[-3:])
        print(f"{args.arch}, {init} init, {opt} lr {lr:g} clip {clip:g}: losses "
              f"{[round(x, 4) for x in losses]}; grad norms {[f'{n:.3g}' for n in norms]}; "
              f"mean of the last three {last:.4f} {'<' if last < losses[0] else '>='} step "
              f"0's {losses[0]:.4f}, {'<' if last < uniform else '>='} ln(vocab) "
              f"{uniform:.4f}; {smi}", flush=True)
        del params, state, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
