"""The cost-based plan compiler — the paper's core contribution (port of
``repro/core/planner.py``; the same lattice walk and selection, sized for
``repro_torch.hw.H100`` unless given another ``HardwareSpec``).

SystemML: "for the given DML script, SystemML's cost-based compiler
automatically generates hybrid runtime execution plans ... depending on data
and cluster characteristics such as data size, data sparsity, cluster size
and memory configurations."

:class:`PlanCompiler` does exactly that for a JAX mesh. Given
(model config x input shape x mesh x hardware budget) it walks the plan
lattice (DESIGN.md §4) from the cheapest strategy to the most distributed
one and returns the first plan whose **worst-case memory estimate** fits the
per-device memory budget, scored by the analytic cost model. The same escalation
SystemML performs between "driver JVM single-node plan" and "distributed
RDD plan" happens here between LOCAL / DATA_PARALLEL / +TP / FSDP /
opt-state-compression / gradient-accumulation.

One difference from the reference, for training on one card: the
reference's single-device lattice holds one plan (LOCAL, float32 optimizer
state unless the caller asks otherwise), because its single device is a CPU
for tests while its deployments are meshes. On the H100 one card is a
deployment, so there LOCAL walks on as the multi-device lattice does:
optimizer state compressed to bfloat16 (unless it is bfloat16 already),
then gradient accumulation in doubling microbatches. A 6B
model's float32 Adam state and master copy alone (72 GB) do not fit one
card. Under any other ``HardwareSpec`` the lattice is the reference's.
"""

from __future__ import annotations

from typing import Iterator

from repro_torch.config import (
    HardwareSpec,
    InputShape,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from repro_torch.core.cost import analytic_cost, decode_kernel_seconds
from repro_torch.core.memory import ACT_BYTES, cache_page_count, estimate_memory
from repro_torch.core.strategies import ExecutionPlan, PlanConfig, RuntimeStats, Strategy
from repro_torch.hw import H100
from repro_torch.kernels.paged_attention import MAX_GROUP, MAX_HEAD_DIM

LONG_CONTEXT_THRESHOLD = 262_144  # beyond this, full attention must window


class PlanCompiler:
    def __init__(self, hw: HardwareSpec = H100, headroom: float = 0.9,
                 cache_pool_arenas: int = 1, cache_page_size: int = 0,
                 decode_kernel: str = "auto", donate_cache: bool = True):
        self.hw = hw
        self.headroom = headroom
        # decode statistics are sized for a KV-cache pool provisioned for
        # this many concurrent bucket arenas (repro_torch.runtime.kv_cache);
        # 1 keeps the single-blob seed behaviour for dryruns/tests.
        # cache_page_size > 0 sizes the attention K/V term at block
        # granularity (pages the paged pool can physically commit) and is
        # what the pool's page-exact live bytes are compared against.
        self.cache_pool_arenas = cache_pool_arenas
        self.cache_page_size = cache_page_size
        # "auto": pick the physical decode-attention operator per bucket
        # from the analytic cost terms; anything else forces that operator
        # on every decode plan (the --decode-kernel escape hatch).
        if decode_kernel not in ("auto", "paged", "gather", "ref"):
            raise ValueError(f"unknown decode_kernel {decode_kernel!r}")
        self.decode_kernel = decode_kernel
        # decode steps donate their cache argument (in-place KV update);
        # False charges the transient second arena copy of a step that
        # returns a fresh cache. The port's step always updates in place,
        # so its PlanServer passes True; False is kept for comparing the
        # statistics with the reference's un-donated plans
        self.donate_cache = bool(donate_cache)

    def selection_trace(
        self, model: ModelConfig, shape: InputShape,
        committed_frac: float = 1.0,
    ) -> dict:
        """Every input and intermediate of decode-kernel selection, as a
        record: the chosen kernel plus *why* — forced knob, attention-free
        short-circuit, the block-fit test, and both candidate analytic
        seconds when the cost comparison actually ran. The fit test is the
        reference's per-block fast-memory test against ``hw.vmem_bytes``
        (on the H100 the opt-in shared memory of one block) and, in the
        port, the shapes ``csrc/paged_decode.cu`` takes (g <= 16, D <= 256),
        so ``auto`` never selects a kernel that would refuse the shape."""
        page = self.cache_page_size
        rec = {
            "kernel": "gather",
            "forced": self.decode_kernel,
            "attention_free": model.layer_pattern().count("a") == 0,
            "page": page,
            "committed_frac": committed_frac,
            "vmem_fit": None,       # None = fit test not reached
            "paged_s": None,
            "gather_s": None,
            "reason": "",
        }
        if rec["attention_free"]:
            rec.update(kernel="none",
                       reason="attention-free family: no decode-attention op")
            return rec
        if self.decode_kernel != "auto":
            rec.update(kernel=self.decode_kernel, reason="forced by compiler")
            return rec
        if shape.kind != "decode" or page <= 0:
            rec.update(reason="dense (non-paged) serving path")
            return rec
        # device-memory fit of the kernel's per-block set: one K and one V
        # physical page + the (g, D) query group + f32 accumulator scratch
        d = model.head_dim
        g = model.q_per_kv
        blk = 2 * page * d * ACT_BYTES + g * d * ACT_BYTES + g * (d + 2) * 4
        takes = g <= MAX_GROUP and d <= MAX_HEAD_DIM
        rec["vmem_fit"] = blk <= self.hw.vmem_bytes * 0.8 and takes
        if not rec["vmem_fit"]:
            rec.update(reason=(
                f"page block {blk}B exceeds the per-block memory budget"
                if takes else
                f"paged kernel takes g <= {MAX_GROUP}, D <= {MAX_HEAD_DIM}; "
                f"got g={g}, D={d}"))
            return rec
        paged_s = decode_kernel_seconds(model, shape, self.hw, "paged", page,
                                        committed_frac)
        gather_s = decode_kernel_seconds(model, shape, self.hw, "gather", page,
                                         committed_frac)
        rec.update(paged_s=paged_s, gather_s=gather_s,
                   kernel="paged" if paged_s < gather_s else "gather",
                   reason="analytic cost comparison")
        return rec

    def _select_decode_kernel(
        self, model: ModelConfig, shape: InputShape,
        committed_frac: float = 1.0,
    ) -> str:
        """SystemML-style operator selection for the decode hot path.

        Data characteristics decide: page count and window (via the
        effective cached sequence), batch, and head dims enter through the
        analytic cost terms in :mod:`repro_torch.core.cost`; the block fit of
        one physical page plays SystemML's device-memory-fit test. Worst-case
        commitment (``committed_frac=1``) at compile time; dynamic
        recompilation re-enters with the observed fraction.
        """
        return self.selection_trace(model, shape, committed_frac)["kernel"]

    def _cache_kwargs(self, model: ModelConfig, shape: InputShape) -> dict:
        kw = {"cache_pool_arenas": self.cache_pool_arenas}
        if shape.kind == "decode":
            kw["donate_cache"] = self.donate_cache
        if self.cache_page_size and shape.kind == "decode":
            kw["cache_page_size"] = self.cache_page_size
            kw["cache_pages"] = self.cache_pool_arenas * cache_page_count(
                model, shape.seq_len, shape.global_batch,
                self.cache_page_size)
        return kw

    # ------------------------------------------------------------------
    def compile(
        self,
        model: ModelConfig,
        shape: InputShape,
        mesh: MeshConfig,
        train: TrainConfig = TrainConfig(),
        mem_scale: float = 1.0,
        dtype: str = "bfloat16",
    ) -> ExecutionPlan:
        """Walk the plan lattice and return the first fitting plan.

        ``mem_scale`` is the dynamic-recompilation hook: when a plan's
        observed memory watermark exceeded its compile-time estimate, the
        recompile pass re-enters here with the observed/estimated correction
        factor, so every candidate is judged (and the chosen plan is
        annotated) with runtime-corrected statistics. ``dtype`` is the actual
        compute dtype — compile-time statistics are sized for it.
        """
        chosen = None
        candidates = list(self._candidates(model, shape, mesh, train))
        if train.force_strategy:
            candidates = [
                c for c in candidates if c.strategy.value == train.force_strategy
            ] or candidates
        for cand in candidates:
            mem = estimate_memory(model, shape, mesh, cand, train, self.hw, dtype,
                                  **self._cache_kwargs(model, shape))
            if mem_scale != 1.0:
                mem = mem.scaled(mem_scale)
            if mem.fits(self.headroom):
                chosen, chosen_mem = cand, mem
                break
        else:
            # nothing fits: emit the most distributed plan with a warning,
            # exactly like SystemML emitting a distributed plan that spills.
            chosen = candidates[-1].replace(
                notes=candidates[-1].notes
                + ("WARNING: worst-case estimate exceeds HBM budget",)
            )
            chosen_mem = estimate_memory(model, shape, mesh, chosen, train, self.hw,
                                         dtype,
                                         **self._cache_kwargs(model, shape))
            if mem_scale != 1.0:
                chosen_mem = chosen_mem.scaled(mem_scale)
        if shape.kind == "decode":
            chosen = chosen.replace(
                decode_kernel=self._select_decode_kernel(model, shape),
                donate_cache=self.donate_cache)
        cost = analytic_cost(model, shape, mesh, chosen, self.hw,
                             page=self.cache_page_size, dtype=dtype)
        return ExecutionPlan(
            model=model, shape=shape, mesh=mesh, config=chosen,
            memory=chosen_mem, cost=cost, dtype=dtype,
        )

    # ------------------------------------------------------------------
    def recompile(
        self,
        prior: ExecutionPlan,
        stats: RuntimeStats,
        train: TrainConfig = TrainConfig(),
    ) -> ExecutionPlan:
        """Dynamic recompilation (SystemML §2): re-enter the compiler with
        *observed* runtime characteristics replacing the compile-time
        worst-case assumptions of ``prior``.

        Two divergences are corrected: (1) the actual request shape grew
        beyond the compiled shape — the plan is recompiled for the larger
        shape; (2) the measured memory watermark exceeded the compile-time
        estimate — every candidate estimate is inflated by the observed
        correction factor so the lattice walk escalates honestly.
        """
        shape = prior.shape
        if (stats.shape.seq_len > shape.seq_len
                or stats.shape.global_batch > shape.global_batch):
            shape = InputShape(
                name=f"{shape.kind}_recompiled",
                seq_len=max(shape.seq_len, stats.shape.seq_len),
                global_batch=max(shape.global_batch, stats.shape.global_batch),
                kind=shape.kind,
            )
        scale = 1.0
        if (stats.watermark_bytes
                and prior.memory is not None and prior.memory.total > 0):
            scale = max(1.0, stats.watermark_bytes / prior.memory.total)
        plan = self.compile(prior.model, shape, prior.mesh, train,
                            mem_scale=scale, dtype=prior.dtype)
        # Corrected statistics must cover the observation even when the
        # lattice walk escalated to a candidate with a smaller base
        # estimate — otherwise the same watermark breaches again on the
        # next request and recompilation never converges. Worst-case
        # estimates never under-estimate (core.memory contract).
        if (stats.watermark_bytes and plan.memory is not None
                and 0 < plan.memory.total < stats.watermark_bytes):
            plan.memory = plan.memory.scaled(
                stats.watermark_bytes / plan.memory.total)
        # KV-cache pool breach: the pool outgrew the compile-time cache
        # statistic — correct it to cover the observation so an identical
        # pool occupancy does not re-trigger recompilation (same
        # converge-after-one contract as the watermark correction above).
        if stats.cache_pool_bytes and plan.memory is not None:
            kv_est = plan.memory.per_device.get("kv_cache", 0.0)
            if 0 < kv_est < stats.cache_pool_bytes:
                plan.memory.per_device["kv_cache"] = float(stats.cache_pool_bytes)
        # Decode-kernel re-selection with *observed* page commitment: the
        # compile-time choice assumed every row at bucket depth; if the
        # observed committed pages per row diverge, the cost comparison is
        # re-run with the real fraction and can flip the physical operator
        # (the fused kernel skips uncommitted pages, the gather cannot).
        if (shape.kind == "decode" and stats.committed_pages_per_row
                and self.cache_page_size):
            worst = cache_page_count(
                prior.model, shape.seq_len, shape.global_batch,
                self.cache_page_size) / max(1, shape.global_batch)
            frac = min(1.0, stats.committed_pages_per_row / max(1.0, worst))
            kernel = self._select_decode_kernel(prior.model, shape, frac)
            if kernel != plan.config.decode_kernel:
                plan.config = plan.config.replace(
                    decode_kernel=kernel,
                    notes=plan.config.notes + (
                        f"decode kernel flipped to {kernel}: observed "
                        f"{stats.committed_pages_per_row:.1f}/{worst:.0f} "
                        "pages/row",
                    ),
                )
                plan.cost = analytic_cost(prior.model, shape, prior.mesh,
                                          plan.config, self.hw,
                                          page=self.cache_page_size,
                                          dtype=prior.dtype)
        plan.config = plan.config.replace(
            notes=plan.config.notes
            + (f"dynamic recompilation: runtime stats correction x{scale:.2f}",)
        )
        return plan

    # ------------------------------------------------------------------
    def _attention_variant(self, model: ModelConfig, shape: InputShape) -> str:
        if model.family == "ssm":
            return "none"
        if model.window_size:
            return "window"
        if shape.seq_len > LONG_CONTEXT_THRESHOLD:
            return "window"  # sliding-window serving variant (DESIGN §5)
        return "full"

    def _candidates(
        self,
        model: ModelConfig,
        shape: InputShape,
        mesh: MeshConfig,
        train: TrainConfig,
    ) -> Iterator[PlanConfig]:
        variant = self._attention_variant(model, shape)
        data_axes = mesh.data_axes
        batch_axes = data_axes if shape.global_batch % max(1, _size(mesh, data_axes)) == 0 else ()
        is_moe = model.num_experts > 0

        if mesh.num_devices == 1:
            # single-node plan — SystemML's driver-JVM case
            local = PlanConfig(
                strategy=Strategy.LOCAL,
                batch_axes=(),
                attention_variant=variant,
                remat=train.remat,
                microbatches=1,
                opt_state_dtype=train.opt_state_dtype or "float32",
            )
            yield local
            if shape.kind == "train" and self.hw.name == H100.name:
                yield from self._local_train_escalation(local, shape, train)
            return

        if shape.kind == "train":
            yield from self._train_candidates(
                model, shape, mesh, train, variant, batch_axes, is_moe
            )
        else:
            yield from self._serve_candidates(
                model, shape, mesh, variant, batch_axes, is_moe
            )

    @staticmethod
    def _local_train_escalation(local: PlanConfig, shape: InputShape,
                                train: TrainConfig) -> Iterator[PlanConfig]:
        """One card's training plans past LOCAL, in the multi-device
        lattice's order, conditions and notes: bfloat16 optimizer state
        (unless it is already), then gradient accumulation x2, x4, ... up
        to the batch."""
        plan = local
        if (train.opt_state_dtype or "float32") == "float32":
            plan = plan.replace(opt_state_dtype="bfloat16",
                                notes=("opt-state compressed to bf16 by planner",))
            yield plan
        micro = 2
        while micro <= shape.global_batch:
            yield plan.replace(microbatches=micro,
                               notes=plan.notes + (f"grad-accum x{micro}",))
            micro *= 2

    def _train_candidates(self, model, shape, mesh, train, variant, batch_axes, is_moe):
        base = PlanConfig(
            strategy=Strategy.DATA_PARALLEL,
            batch_axes=batch_axes,
            attention_variant=variant,
            remat=train.remat,
            opt_state_dtype=train.opt_state_dtype or "float32",
            notes=("paper-faithful data-parallel plan",),
        )
        yield base
        tp = base.replace(
            strategy=Strategy.DP_TP,
            tensor_parallel=True,
            expert_parallel=is_moe,
            notes=(),
        )
        yield tp
        fsdp = tp.replace(strategy=Strategy.FSDP_TP, params_over_data=True)
        yield fsdp
        if (train.opt_state_dtype or "float32") == "float32":
            # plan-chosen optimizer-state compression (DESIGN §4)
            fsdp_bf16 = fsdp.replace(
                opt_state_dtype="bfloat16",
                notes=("opt-state compressed to bf16 by planner",),
            )
            yield fsdp_bf16
        else:
            fsdp_bf16 = fsdp
        # Megatron-style sequence-parallel residual checkpoints (beyond-paper)
        if shape.seq_len % mesh.model_parallelism == 0:
            fsdp_bf16 = fsdp_bf16.replace(
                seq_shard_checkpoints=True,
                notes=fsdp_bf16.notes + ("seq-parallel remat checkpoints",),
            )
            yield fsdp_bf16
        # escalating gradient accumulation to shrink activations
        b_dev = max(1, shape.global_batch // max(1, _size(mesh, batch_axes)))
        micro = 2
        while micro <= b_dev:
            yield fsdp_bf16.replace(
                microbatches=micro,
                notes=fsdp_bf16.notes + (f"grad-accum x{micro}",),
            )
            micro *= 2

    def _serve_candidates(self, model, shape, mesh, variant, batch_axes, is_moe):
        mp = mesh.model_parallelism
        kv = model.num_kv_heads
        heads_ok = kv >= mp and kv % mp == 0
        # long-context: also spread cached sequence over idle axes
        seq_axes_all = tuple(
            a for a in mesh.axis_names if not batch_axes or a not in batch_axes
        )
        base = PlanConfig(
            strategy=Strategy.DATA_PARALLEL,
            batch_axes=batch_axes,
            cache_batch_axes=batch_axes,
            attention_variant=variant,
            remat=False,
            microbatches=1,
            notes=("paper-faithful data-parallel plan (weights replicated)",),
        )
        yield base
        # + tensor parallel on weights; cache sharded on heads if divisible,
        # else on sequence over the model axis
        tp = base.replace(
            strategy=Strategy.DP_TP,
            tensor_parallel=True,
            expert_parallel=is_moe,
            cache_heads_over_model=heads_ok,
            cache_seq_axes=() if heads_ok else ("model",),
            notes=(),
        )
        if model.family == "ssm":
            tp = tp.replace(cache_heads_over_model=True, cache_seq_axes=())
        yield tp
        # prefill context parallelism: seq sharded over "model", K/V
        # all-gathered per layer (beyond-paper escalation)
        cp = None
        if shape.kind == "prefill" and shape.seq_len % mp == 0:
            cp = tp.replace(
                seq_axes=("model",),
                notes=("context-parallel prefill: seq over model axis",),
            )
            yield cp
        # long-context escalation: sequence over every non-batch axis
        if shape.seq_len > LONG_CONTEXT_THRESHOLD or shape.global_batch == 1:
            yield tp.replace(
                cache_heads_over_model=False,
                cache_seq_axes=seq_axes_all,
                notes=("cache sequence spread over all idle mesh axes",),
            )
        # last resorts: weights over data too (per-layer all-gather at serve)
        yield tp.replace(
            strategy=Strategy.FSDP_TP,
            params_over_data=True,
            notes=("serve-time FSDP: params all-gathered per layer",),
        )
        if cp is not None:
            yield cp.replace(
                strategy=Strategy.FSDP_TP,
                params_over_data=True,
                notes=cp.notes + ("serve-time FSDP: params all-gathered per layer",),
            )


def _size(mesh: MeshConfig, axes) -> int:
    n = 1
    for nm, sz in zip(mesh.axis_names, mesh.shape):
        if nm in axes:
            n *= sz
    return n


def compile_plan(model, shape, mesh, train=TrainConfig(), hw=H100,
                 dtype="bfloat16") -> ExecutionPlan:
    return PlanCompiler(hw).compile(model, shape, mesh, train, dtype=dtype)
