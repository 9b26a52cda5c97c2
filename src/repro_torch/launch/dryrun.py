"""Pod-scale dry run (port of ``repro/launch/dryrun.py``).

For every (architecture × ``INPUT_SHAPES`` entry × pod mesh) combination
the planner's plan for the reference's (16, 16) ``("data", "model")`` or
(2, 16, 16) ``("pod", "data", "model")`` mesh is traced for one rank, and
one JSON record per combination says whether the plan fits an H100 and
which of compute, memory or collectives sets the pace, per H100 of a
256- or 512-card mesh.

The reference compiles each step with ``jax.jit(...).lower(...).compile()``
on 512 placeholder host devices and reads the per-chip HLO. The port has
no such compiler: it traces rank 0's step (``analysis/plan_audit``'s
``trace_cell`` on a ``launch/mesh.TracedMesh``) into an aten graph on fake
``cuda`` tensors of that rank's blocks, with every collective written out
by ``ShardCtx`` / ``core/comm.py`` counted over ``comm.TraceGroup``
stand-ins instead of sent, and costs the graph
(``launch/graph_analysis.py``). Train steps are ``make_train_step``, the
prompt pass ``make_prefill`` and decode the dense ``make_decode_step``, each
under the plan's layout, as the reference lowers them (``_lower_train``,
``_lower_prefill``, ``_lower_decode``). Where the installed PyTorch has no
CUDA (its autograd engine cannot record on fake ``cuda`` tensors) the trace
is the CPU path's (``traced_on`` in the record).

Depth: no stack is traced at 126 layers. Each stack is traced at two and
at three periods of its layer pattern (the ``rra`` period for
RecurrentGemma, with the layers past the last whole period in both;
Whisper's encoder and decoder apart) and every count is extrapolated
linearly to the full depth, the part that trip-count weighting plays in
the reference's HLO analysis (``hlo_analysis._cond_trip_count``). FLOPs,
bytes and collectives are linear from the first period on; the peak is
not: a one-layer train step's peak sits 32 KiB below the line the deeper
ones lie on (Mamba-2's smoke widths), so the first traced depth is two
periods.

Each record has the reference's keys, renamed where they count something
else: ``trace_seconds`` for ``compile_seconds``, ``graph_cost`` for
``hlo_cost``; ``memory`` (argument, output, temp, alias and peak bytes of
the liveness walk; ``hbm_budget`` is ``hw.H100``'s), ``roofline``
(``core/cost.roofline_terms`` on ``hw.H100``), ``planner_estimate`` and
``planner_cost``; there is no ``xla_cost_analysis``. Records go to
``build/dryrun/``.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--skip-existing]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch X --shape Y \\
      --force-strategy data_parallel        # paper-faithful baseline
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.plan_audit import trace_cell
from repro_torch.config import INPUT_SHAPES, HardwareSpec, ModelConfig, TrainConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.cost import model_flops_per_step, roofline_terms
from repro_torch.core.planner import compile_plan
from repro_torch.hw import H100
from repro_torch.launch import graph_analysis
from repro_torch.launch.mesh import make_production_mesh, mesh_cfg_for
from repro_torch.models.model import build_model
from repro_torch.runtime.train_loop import batch_input_specs  # noqa: F401  (the reference's name)

OUT_DIR = str(Path(__file__).resolve().parents[3] / "build" / "dryrun")
# the card's path, on fake tensors; a PyTorch built without CUDA cannot
# record autograd on fake ``cuda`` tensors (its engine asks for the
# device), so there the dry run traces the CPU path, whose collectives,
# kernels at these shapes and layouts are the card's
TRACE_DEVICE = "cuda" if torch.backends.cuda.is_built() else "cpu"


BASE_PERIODS = 2


def depth_plan(cfg: ModelConfig) -> Tuple[Dict, List[Tuple[Dict, float]]]:
    """The traces that stand for ``cfg`` at full depth: the base cut (each
    stack at ``BASE_PERIODS`` periods of its layer pattern, plus the layers
    past the last whole period) and, for each stack, ``(cut with one more
    period, periods still to add)`` — what :func:`graph_analysis.extrapolate`
    takes. A stack no deeper than the base is traced whole."""
    k = BASE_PERIODS
    if cfg.is_encdec:
        e, d = min(k, cfg.encoder_layers), min(k, cfg.num_layers)
        more = []
        if cfg.encoder_layers > e:
            more.append(({"num_layers": d, "encoder_layers": e + 1}, cfg.encoder_layers - e))
        if cfg.num_layers > d:
            more.append(({"num_layers": d + 1, "encoder_layers": e}, cfg.num_layers - d))
        return {"num_layers": d, "encoder_layers": e}, more
    period = len(cfg.block_pattern) if cfg.family == "hybrid" and cfg.block_pattern else 1
    rem = cfg.num_layers % period
    n = (cfg.num_layers - rem) // period
    if n <= k:
        return {"num_layers": cfg.num_layers}, []
    return ({"num_layers": k * period + rem},
            [({"num_layers": (k + 1) * period + rem}, n - k)])


def _trace_cost(cfg: ModelConfig, cut: Dict, plan, mesh,
                train_cfg: TrainConfig) -> graph_analysis.GraphCost:
    model = build_model(dataclasses.replace(cfg, **cut), dtype=torch.bfloat16)
    trace = trace_cell(model, plan, plan.shape.kind, plan.shape.global_batch,
                       plan.shape.seq_len, mesh=mesh, train=train_cfg, device=TRACE_DEVICE)
    if trace.gm is None:
        raise RuntimeError(f"the step did not trace: {trace.error}")
    return graph_analysis.analyze(trace.gm, trace.collectives)


def trace_combo(cfg: ModelConfig, plan, mesh, train_cfg: TrainConfig = TrainConfig(),
                full_depth: bool = False):
    """One rank's cost of ``plan`` at ``cfg``'s full depth: extrapolated
    from the period traces of :func:`depth_plan`, or with ``full_depth``
    traced whole. Returns ``(cost, the layer counts traced)``."""
    if full_depth:
        cut = {"num_layers": cfg.num_layers}
        if cfg.is_encdec:
            cut["encoder_layers"] = cfg.encoder_layers
        return _trace_cost(cfg, cut, plan, mesh, train_cfg), [cut]
    base_cut, more = depth_plan(cfg)
    base = _trace_cost(cfg, base_cut, plan, mesh, train_cfg)
    steps = [(_trace_cost(cfg, cut, plan, mesh, train_cfg), n) for cut, n in more]
    return graph_analysis.extrapolate(base, steps), [base_cut] + [c for c, _n in more]


def plan_fields(config) -> Dict:
    """The plan's layout fields of a record, the reference's keys."""
    return {
        "batch_axes": list(config.batch_axes),
        "seq_axes": list(config.seq_axes),
        "tensor_parallel": config.tensor_parallel,
        "params_over_data": config.params_over_data,
        "expert_parallel": config.expert_parallel,
        "opt_state_dtype": config.opt_state_dtype,
        "microbatches": config.microbatches,
        "seq_shard_checkpoints": config.seq_shard_checkpoints,
        "attention_variant": config.attention_variant,
        "cache_batch_axes": list(config.cache_batch_axes),
        "cache_heads_over_model": config.cache_heads_over_model,
        "cache_seq_axes": list(config.cache_seq_axes),
    }


def combo_plan(arch: str, shape_name: str, multi_pod: bool = False,
               train_cfg: TrainConfig = TrainConfig(), hw: HardwareSpec = H100):
    """The planner's plan of a combination (``core/planner.compile_plan``
    for the pod mesh, on ``hw``)."""
    return compile_plan(get_config(arch), INPUT_SHAPES[shape_name],
                        mesh_cfg_for(multi_pod=multi_pod), train_cfg, hw=hw)


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
                force_strategy: Optional[str] = None,
                train_cfg: TrainConfig = TrainConfig(), plan_override=None):
    """Trace and cost one combination for rank 0 of the pod mesh; returns
    ``(record, cost, plan)``."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh_cfg = mesh_cfg_for(multi_pod=multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod)
    if force_strategy:
        train_cfg = dataclasses.replace(train_cfg, force_strategy=force_strategy)
    plan = plan_override or combo_plan(arch, shape_name, multi_pod, train_cfg)
    t0 = time.perf_counter()
    cost, traced = trace_combo(cfg, plan, mesh, train_cfg)
    trace_s = time.perf_counter() - t0
    chips = mesh_cfg.num_devices
    mf = model_flops_per_step(cfg, shape)
    terms = roofline_terms(cost.flops, cost.hbm_bytes, cost.collective_bytes, chips, H100,
                           model_flops=mf, per_chip=True)
    memory = {k: cost.memory[k] for k in graph_analysis.MEMORY_KEYS}
    memory["hbm_budget"] = H100.hbm_bytes
    memory["fits"] = memory["peak_estimate_bytes"] <= H100.hbm_bytes
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": list(mesh_cfg.shape),
        "multi_pod": multi_pod,
        "rank": mesh.rank,
        "strategy": plan.config.strategy.value,
        "plan_notes": list(plan.config.notes),
        "plan": plan_fields(plan.config),
        "trace_seconds": trace_s,
        "traced_on": f"fake {TRACE_DEVICE}",
        "depth": {"layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
                  "traced": traced},
        "memory": memory,
        "graph_cost": cost.to_dict(),
        "roofline": {
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "model_flops_global": mf,
            "model_flops_per_chip": mf / chips,
            "useful_flops_ratio": (mf / chips) / cost.flops if cost.flops else 0.0,
            "step_time_lower_bound_s": terms.step_time_s,
        },
        "planner_estimate": dict(plan.memory.per_device),
        "planner_cost": {
            "compute_s": plan.cost.compute_s,
            "memory_s": plan.cost.memory_s,
            "collective_s": plan.cost.collective_s,
        },
    }
    return record, cost, plan


def combo_tag(arch: str, shape_name: str, multi_pod: bool,
              force_strategy: Optional[str] = None) -> str:
    tag = f"{arch}_{shape_name}_{'2pod' if multi_pod else '1pod'}"
    return f"{tag}_{force_strategy}" if force_strategy else tag


def run_one(arch: str, shape_name: str, multi_pod: bool, force_strategy: Optional[str] = None,
            out_dir: str = OUT_DIR) -> Dict:
    """Trace one combination and write its record; a combination the port
    cannot trace is recorded with ``ok: false`` and its error."""
    tag = combo_tag(arch, shape_name, multi_pod, force_strategy)
    os.makedirs(out_dir, exist_ok=True)
    try:
        record = lower_combo(arch, shape_name, multi_pod=multi_pod,
                             force_strategy=force_strategy)[0]
        record["ok"] = True
    except Exception as e:  # noqa: BLE001 — recorded as a dry-run failure
        record = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "ok": False,
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(record, f, indent=1)
    status = "OK " if record.get("ok") else "FAIL"
    peak = record.get("memory", {}).get("peak_estimate_bytes", 0) / 2**30
    dom = record.get("roofline", {}).get("dominant", "?")
    print(f"[{status}] {tag:60s} peak={peak:7.2f}GiB dominant={dom} "
          f"strategy={record.get('strategy', '?')} "
          f"traced in {record.get('trace_seconds', 0.0):.1f} s", flush=True)
    return record


def summary(records: Sequence[Dict]) -> List[str]:
    """One line a record: the combination, whether its peak fits an H100,
    the peak, the dominant roofline term and its lower bound on the step,
    and the plan's strategy."""
    lines = []
    for r in records:
        tag = combo_tag(r["arch"], r["shape"], r["multi_pod"])
        if not r.get("ok"):
            lines.append(f"{tag}: FAIL {r.get('error', '')[:120]}")
            continue
        mem, rf = r["memory"], r["roofline"]
        lines.append(f"{tag}: fits {mem['fits']} peak {mem['peak_estimate_bytes'] / 2**30:.2f} GiB"
                     f" dominant {rf['dominant']} step >= {rf['step_time_lower_bound_s']:.4g} s"
                     f" ({r['strategy']})")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS + ["all"], default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES) + ["all"], default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="all archs, shapes, meshes")
    ap.add_argument("--force-strategy", default=None)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch in (None, "all")) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape == "all") else [args.shape]
    meshes = [False, True] if (args.all or args.both_meshes) else [args.multi_pod]

    failures = 0
    records = []
    t0 = time.perf_counter()
    for mp in meshes:
        for arch in archs:
            for shape_name in shapes:
                tag = combo_tag(arch, shape_name, mp, args.force_strategy)
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        rec = json.load(f)
                    if rec.get("ok"):
                        print(f"[SKIP] {tag}", flush=True)
                        records.append(rec)
                        continue
                rec = run_one(arch, shape_name, mp, args.force_strategy, args.out)
                records.append(rec)
                failures += 0 if rec.get("ok") else 1
    print("\n".join(["summary (per H100 of the mesh):"] + summary(records)))
    print(f"dryrun: {len(records)} record(s), {failures} failure(s), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
