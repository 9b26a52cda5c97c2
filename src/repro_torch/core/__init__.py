"""repro_torch.core — the paper's compiler: memory-estimate-driven, cost-based
generation of distributed execution plans, the sharding rules and parfor
(the port of ``repro.core``; the same names)."""

from repro_torch.core.planner import PlanCompiler, compile_plan
from repro_torch.core.strategies import ExecutionPlan, PlanConfig, RuntimeStats, Strategy
from repro_torch.core.memory import MemoryEstimate, estimate_memory
from repro_torch.core.cost import CostEstimate, analytic_cost, roofline_terms
from repro_torch.core.sharding import spec_for, tree_specs
from repro_torch.core.parfor import parfor, choose_parfor_plan, count_collectives
from repro_torch.core.plan_cache import (BucketPolicy, CacheEntry, PlanCache,
                                         PlanCacheMetrics, PlanKey, bucket_pow2,
                                         recompile_reasons)

__all__ = [
    "PlanCompiler", "compile_plan", "ExecutionPlan", "PlanConfig", "Strategy",
    "RuntimeStats", "MemoryEstimate", "estimate_memory", "CostEstimate",
    "analytic_cost", "roofline_terms", "spec_for", "tree_specs", "parfor",
    "choose_parfor_plan", "count_collectives", "BucketPolicy", "CacheEntry",
    "PlanCache", "PlanCacheMetrics", "PlanKey", "bucket_pow2",
    "recompile_reasons",
]
