"""Batched serving: prefill a batch of prompts, then greedy-decode
continuation tokens from the cache the prompt pass populated — the port's
twin of ``examples/serve_batched.py``. The plan the compiler chooses for the
request's shape is printed first; the attention-free Mamba-2 family is the
default (constant-memory state).

    PYTHONPATH=src python -m repro_torch.launch.serve_batched [--device cpu]
        [--arch yi-6b-smoke] [--batch 4] [--prompt-len 32] [--gen 32]

Runs on the card unless ``--device`` names another device; prints the
prefill and decode rates and ``OK``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.config import SINGLE_DEVICE_MESH, InputShape
from repro_torch.configs import get_config
from repro_torch.core.planner import compile_plan
from repro_torch.models.model import build_model
from repro_torch.runtime.engine import sync
from repro_torch.runtime.serve_loop import greedy_decode, make_decode_step, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-1.3b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without a card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    model = build_model(cfg, dtype=torch.float32)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))

    context = args.prompt_len + args.gen
    plan = compile_plan(cfg, InputShape("serve", context, args.batch, "decode"),
                        SINGLE_DEVICE_MESH, dtype="float32")
    print(plan.explain())

    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device, dtype=torch.int32)
    # one full-sequence prompt pass scores the prompt AND populates the
    # decode cache (prefill -> decode handoff): decode continues at the
    # prompt's position instead of restarting from zeros
    step = make_decode_step(model)
    t0 = time.perf_counter()
    last_logits, cache = model.prefill(params, prompts, cache_len=context)
    sync(device)
    prefill_s = time.perf_counter() - t0

    first = torch.argmax(last_logits, dim=-1).to(torch.int32)[:, None]
    t0 = time.perf_counter()
    toks, cache = greedy_decode(model, params, cache, first, args.prompt_len, args.gen,
                                decode_step=step)
    sync(device)
    decode_s = time.perf_counter() - t0

    print(f"prefill: {args.prompt_len * args.batch / prefill_s:.1f} tok/s   "
          f"decode: {args.gen * args.batch / decode_s:.1f} tok/s   on {device}")
    print("generated:", toks[0].tolist()[:16], "...")
    print("OK")


if __name__ == "__main__":
    main()
