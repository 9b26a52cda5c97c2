"""The plans that ``tests/test_torch_dryrun.py`` traces for a rank and that
its gloo ranks run (``_torch_ranks.dryrun_count_case``): the planner's
train plan forced to a strategy, or a ``DP_TP`` serve plan, each with
config fields replaced. Imports torch and the port only (the ranks import
it)."""

from __future__ import annotations

from repro_torch.config import InputShape, TrainConfig
from repro_torch.core.planner import compile_plan
from repro_torch.core.strategies import ExecutionPlan, PlanConfig, Strategy


def plan_of(cfg, kind, fields, mesh_cfg, batch, seq) -> ExecutionPlan:
    shape = InputShape(kind, seq, batch, kind)
    fields = dict(fields)
    if kind == "train":
        strategy = fields.pop("strategy", "fsdp_tensor_parallel")
        plan = compile_plan(cfg, shape, mesh_cfg, TrainConfig(force_strategy=strategy),
                            dtype="float32")
        return ExecutionPlan(model=cfg, shape=shape, mesh=mesh_cfg,
                             config=plan.config.replace(**fields))
    config = PlanConfig(strategy=Strategy.DP_TP, batch_axes=("data",), cache_batch_axes=("data",),
                        tensor_parallel=True, remat=False, **fields)
    return ExecutionPlan(model=cfg, shape=shape, mesh=mesh_cfg, config=config)
