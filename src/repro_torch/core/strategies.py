"""Execution-plan IR (port of ``repro/core/strategies.py``).

SystemML's compiler output is a *hybrid runtime execution plan*: a choice of
single-node vs distributed operators per op, driven by memory estimates.
The plan IR here: a :class:`PlanConfig` describing how every tensor class
(batch, params, optimizer state, KV cache, experts) is laid out on the
device mesh, plus bookkeeping for the chosen operator variants. The fields,
their defaults and ``ExecutionPlan.explain_axes`` are the reference's, so a
plan of the port and one of the reference compare key by key.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum
from typing import Dict, Tuple

from repro_torch.config import InputShape, MeshConfig, ModelConfig


class Strategy(str, Enum):
    """Named points in the plan lattice (DESIGN.md §4), cheapest first.

    DATA_PARALLEL is the paper-faithful distributed plan (SystemML's
    data-parallel RDD plan: weights replicated, rows partitioned).
    Everything below it is the beyond-paper extension of the same
    memory-driven escalation idea.
    """

    LOCAL = "local"
    DATA_PARALLEL = "data_parallel"
    DP_TP = "dp_tensor_parallel"
    FSDP = "fsdp"
    FSDP_TP = "fsdp_tensor_parallel"

    @property
    def order(self) -> int:
        return list(Strategy).index(self)


@dataclass(frozen=True)
class PlanConfig:
    """Concrete layout decisions for one (model x shape x mesh) run."""

    strategy: Strategy
    # -- tensor layouts ----------------------------------------------------
    batch_axes: Tuple[str, ...] = ()          # batch dim sharded over these
    seq_axes: Tuple[str, ...] = ()            # context parallelism (prefill)
    tensor_parallel: bool = False             # heads/ffn/vocab over "model"
    params_over_data: bool = False            # FSDP: params+grads+opt over data
    expert_parallel: bool = False             # MoE expert dim over "model"
    # -- serving cache layout ---------------------------------------------
    cache_batch_axes: Tuple[str, ...] = ()
    cache_heads_over_model: bool = False
    cache_seq_axes: Tuple[str, ...] = ()      # long-context: shard cached seq
    # -- numeric / scheduling knobs (plan-chosen, SystemML-style) ----------
    opt_state_dtype: str = "float32"
    seq_shard_checkpoints: bool = False       # Megatron-style sequence
    # parallelism for remat'd residual checkpoints (over "model")
    remat: bool = True
    microbatches: int = 1                     # gradient-accumulation chunks
    attention_variant: str = "full"           # full | window | none
    # -- operator variants chosen by format dispatch -----------------------
    # Physical decode-attention operator for paged serving buckets, chosen
    # per bucket by the compiler from the analytic cost terms (SystemML's
    # operator selection by data characteristics): "paged" = the fused CUDA
    # kernel resolving page tables in-kernel; "gather" = gathered view +
    # dense decode attention; "ref" = the oracle path.
    decode_kernel: str = "gather"             # paged | gather | ref
    # Buffer donation for the decode tick. In the reference the jitted step
    # donates its cache argument so the KV slot stack / recurrent state
    # update in place; the port's step always updates in place, and the flag
    # only conditions the memory statistics (an un-donated step is charged
    # a transient second copy of the group's arena). Prefill plans keep
    # False: the prompt pass has no cache input to donate.
    donate_cache: bool = False
    notes: Tuple[str, ...] = ()

    def replace(self, **kw) -> "PlanConfig":
        return dataclasses.replace(self, **kw)


# Every plan *axis* — the PlanConfig fields that parameterize an execution
# plan (``notes`` is free-text provenance, not an axis). EXPLAIN output
# must record each one: a plan axis that can change behaviour without
# showing up in ``ExecutionPlan.explain()`` is an un-debuggable decision.
PLAN_AXES: Tuple[str, ...] = tuple(
    f.name for f in dataclasses.fields(PlanConfig) if f.name != "notes")


@dataclass(frozen=True)
class RuntimeStats:
    """Observed data/runtime characteristics of one executed request.

    SystemML distinguishes *compile-time statistics* (worst-case size and
    sparsity assumptions baked into the plan) from *runtime statistics*
    observed while executing it, and re-optimizes when they diverge. This
    is the runtime side: the actual request shape and the measured live-
    bytes watermark, fed back into :meth:`PlanCompiler.recompile`.

    ``cache_pool_bytes`` is the live size of the row-addressable KV-cache
    pool (``repro_torch.runtime.kv_cache``) at observation time; a pool that has
    outgrown the plan's compile-time cache statistics triggers dynamic
    recompilation exactly like an activation-watermark breach. With paged
    arenas the figure is *page-exact* — committed pages plus leased rows'
    recurrent state, not bucket-shaped arena capacity — so bucket slack no
    longer masquerades as memory pressure and over-triggers the predicate.
    """

    shape: InputShape
    watermark_bytes: float = 0.0
    cache_pool_bytes: float = 0.0
    # Observed committed KV pages per request row (0 = not observed).
    # Compile-time kernel selection assumes worst-case commitment (every
    # row at bucket depth); when the observed page counts diverge, dynamic
    # recompilation re-runs decode-kernel selection with this figure and
    # can flip the operator choice.
    committed_pages_per_row: float = 0.0


@dataclass
class ExecutionPlan:
    """Compiler output: layout config + estimates + EXPLAIN text."""

    model: ModelConfig
    shape: InputShape
    mesh: MeshConfig
    config: PlanConfig
    memory: "object" = None     # core.memory.MemoryEstimate
    cost: "object" = None       # core.cost.CostEstimate
    dtype: str = "bfloat16"     # compute dtype the statistics were sized for

    def explain_axes(self) -> Dict[str, str]:
        """Every plan axis (:data:`PLAN_AXES`), rendered. This is the
        authoritative record behind :meth:`explain`: an axis absent here is
        a plan decision EXPLAIN cannot surface. Add the entry *here* when
        adding a PlanConfig field; ``explain()`` renders from this dict."""
        c = self.config
        return {
            "strategy": c.strategy.value,
            "batch_axes": str(c.batch_axes or "(replicated)"),
            "seq_axes": str(c.seq_axes or "(unsharded)"),
            "tensor_parallel": str(c.tensor_parallel),
            "params_over_data": str(c.params_over_data),
            "expert_parallel": str(c.expert_parallel),
            "cache_batch_axes": str(c.cache_batch_axes or "(replicated)"),
            "cache_heads_over_model": str(c.cache_heads_over_model),
            "cache_seq_axes": str(c.cache_seq_axes or "()"),
            "opt_state_dtype": c.opt_state_dtype,
            "seq_shard_checkpoints": str(c.seq_shard_checkpoints),
            "remat": str(c.remat),
            "microbatches": str(c.microbatches),
            "attention_variant": c.attention_variant,
            "decode_kernel": c.decode_kernel,
            "donate_cache": ("donated (in-place)" if c.donate_cache
                             else "double-buffered"),
        }

    def explain(self) -> str:
        """SystemML-style EXPLAIN output for the generated plan."""
        ax = self.explain_axes()
        lines = [
            f"# EXECUTION PLAN  {self.model.name} x {self.shape.name} "
            f"x mesh{self.mesh.shape} [{self.dtype}]",
            f"strategy:            {ax['strategy']}",
            f"batch sharded over:  {ax['batch_axes']}",
            f"seq sharded over:    {ax['seq_axes']}",
            f"tensor parallel:     {ax['tensor_parallel']}",
            f"params over data:    {ax['params_over_data']} (FSDP/ZeRO)",
            f"expert parallel:     {ax['expert_parallel']}",
            f"opt-state dtype:     {ax['opt_state_dtype']}",
            f"seq-shard ckpts:     {ax['seq_shard_checkpoints']}",
            f"remat:               {ax['remat']}   "
            f"microbatches: {ax['microbatches']}",
            f"attention variant:   {ax['attention_variant']}",
        ]
        if self.shape.is_decode:
            # donation per buffer class: the cache pytree (attention slot
            # stacks + recurrent state) is the only donated step input;
            # params and page tables are read-shared across groups
            lines += [
                f"kv-cache batch axes: {ax['cache_batch_axes']}",
                f"kv-cache heads/model:{ax['cache_heads_over_model']}  "
                f"seq axes:{ax['cache_seq_axes']}",
                f"decode kernel:       {ax['decode_kernel']}",
                f"buffer donation:     kv-cache/recurrent-state "
                f"{ax['donate_cache']}; params, page tables read-only",
            ]
        if self.memory is not None:
            lines.append(self.memory.summary())
        if self.cost is not None:
            lines.append(self.cost.summary())
        for n in self.config.notes:
            lines.append(f"note: {n}")
        return "\n".join(lines)
