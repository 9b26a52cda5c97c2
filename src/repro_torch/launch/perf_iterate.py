"""Plan-variant A/B over the dry run (port of ``repro/launch/perf_iterate.py``).

For a chosen (arch × shape) pair, trace a series of plan variants through
the port's dry run (``launch/dryrun.lower_combo``: one rank of the
reference's (16, 16) mesh, on fake tensors) — the paper-faithful baseline,
the planner's default, then manual hypotheses — and record the three
roofline terms of each on ``hw.H100`` (per H100 of a 256-card mesh), its
peak and its collectives, so that a hypothesis → change → before → after
chain can be read off. The three pairs are the reference's. Rows go to
``build/perf/<pair>.json``.

    PYTHONPATH=src python -m repro_torch.launch.perf_iterate --pair llama_train
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.config import INPUT_SHAPES, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.cost import analytic_cost
from repro_torch.core.memory import estimate_memory
from repro_torch.core.planner import compile_plan
from repro_torch.core.strategies import ExecutionPlan
from repro_torch.hw import H100
from repro_torch.launch.dryrun import lower_combo
from repro_torch.launch.mesh import mesh_cfg_for

OUT = str(Path(__file__).resolve().parents[3] / "build" / "perf")


def _base(arch: str, shape: str):
    return compile_plan(get_config(arch), INPUT_SHAPES[shape], mesh_cfg_for()).config


def variants_llama_train():
    """llama3-405b x train_4k: the worst memory / roofline pair."""
    arch, shape = "llama3-405b", "train_4k"
    base = _base(arch, shape)
    return arch, shape, [
        ("paper_faithful_dp", dict(force_strategy="data_parallel")),
        ("planner_default", dict()),
        ("micro8", dict(plan_override_cfg=base.replace(microbatches=8))),
        ("micro32", dict(plan_override_cfg=base.replace(microbatches=32))),
        ("no_seq_ckpt", dict(plan_override_cfg=base.replace(seq_shard_checkpoints=False))),
        ("fp32_opt", dict(plan_override_cfg=base.replace(opt_state_dtype="float32"))),
    ]


def variants_qwen3_train():
    """qwen3-moe x train_4k: the most collective-bound pair."""
    arch, shape = "qwen3-moe-235b-a22b", "train_4k"
    base = _base(arch, shape)
    return arch, shape, [
        ("paper_faithful_dp", dict(force_strategy="data_parallel")),
        ("planner_default", dict()),
        ("no_expert_parallel", dict(plan_override_cfg=base.replace(expert_parallel=False))),
        ("micro4", dict(plan_override_cfg=base.replace(microbatches=4))),
        ("micro8", dict(plan_override_cfg=base.replace(microbatches=8))),
    ]


def variants_yi_prefill():
    """yi-6b x prefill_32k: the paper's batch-scoring scenario."""
    arch, shape = "yi-6b", "prefill_32k"
    base = _base(arch, shape)
    return arch, shape, [
        ("paper_faithful_dp", dict(force_strategy="data_parallel")),
        ("planner_default", dict()),
        ("context_parallel", dict(plan_override_cfg=base.replace(seq_axes=("model",)))),
        ("no_tensor_parallel", dict(plan_override_cfg=base.replace(tensor_parallel=False))),
    ]


PAIRS = {
    "llama_train": variants_llama_train,
    "qwen3_train": variants_qwen3_train,
    "yi_prefill": variants_yi_prefill,
}


def run_pair(name: str, out_dir: str = OUT) -> list:
    arch, shape, variants = PAIRS[name]()
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for label, kw in variants:
        plan_override = None
        if "plan_override_cfg" in kw:
            cfg, shp, mesh_cfg = get_config(arch), INPUT_SHAPES[shape], mesh_cfg_for()
            pcfg = kw["plan_override_cfg"]
            plan_override = ExecutionPlan(
                model=cfg, shape=shp, mesh=mesh_cfg, config=pcfg,
                memory=estimate_memory(cfg, shp, mesh_cfg, pcfg, TrainConfig(), H100),
                cost=analytic_cost(cfg, shp, mesh_cfg, pcfg, H100))
        try:
            rec, _, _ = lower_combo(arch, shape, force_strategy=kw.get("force_strategy"),
                                    plan_override=plan_override)
            rf, mem = rec["roofline"], rec["memory"]
            row = {
                "label": label,
                "compute_s": rf["compute_s"],
                "memory_s": rf["memory_s"],
                "collective_s": rf["collective_s"],
                "dominant": rf["dominant"],
                "step_lower_bound_s": rf["step_time_lower_bound_s"],
                "useful_flops": rf["useful_flops_ratio"],
                "peak_gib": mem["peak_estimate_bytes"] / 2**30,
                "collectives_gib": {k: v / 2**30 for k, v in
                                    rec["graph_cost"]["collectives"].items()},
            }
        except Exception as e:  # noqa: BLE001 — recorded as the variant's result
            row = {"label": label, "error": f"{type(e).__name__}: {e}"}
        results.append(row)
        print(json.dumps(row), flush=True)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump({"arch": arch, "shape": shape, "hardware": H100.name, "results": results},
                  f, indent=1)
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pair", choices=list(PAIRS) + ["all"], default="all")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    for p in (list(PAIRS) if args.pair == "all" else [args.pair]):
        print(f"== {p}")
        run_pair(p, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
