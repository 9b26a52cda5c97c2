"""Three-term roofline cost model (port of ``repro/core/cost.py``; the
same terms, with the H100's own paged-kernel dispatch figure).

SystemML's optimizer is *cost-based*: it compares candidate plans with an
analytic cost model before emitting one. Ours scores each candidate plan
with the three roofline terms used throughout EXPERIMENTS.md:

    compute term    = FLOPs            / (devices x peak_FLOP/s)
    memory term     = HBM bytes        / (devices x HBM_bw)
    collective term = collective bytes / (devices x link_bw)

Two entry points:

* :func:`analytic_cost` — napkin-math terms from the model config alone
  (planner-side, used to *choose* plans).
* :func:`roofline_terms` — the same three terms from *measured* numbers
  (operations, bytes and collective bytes of a run), to *report* plans.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from repro_torch.config import HardwareSpec, InputShape, MeshConfig, ModelConfig
from repro_torch.core.memory import (ACT_BYTES, PARAM_BYTES, _cache_dense_bytes,
                               _cache_eff_seq, dtype_bytes)
from repro_torch.core.strategies import PlanConfig

# Paged-kernel dispatch cost per (layer, row, kv-head, page) step, in
# seconds: it keeps the selection a genuine comparison (SystemML-style
# operator selection by data characteristics, not a fixed winner), since a
# bucket with many tiny pages pays it linearly. The figure is the H100's
# own, fitted from csrc/paged_decode.cu's profiler device time at the Yi-6B
# serving shape (B 8, Hkv 4, Sc 2048, page 64, bfloat16: 1024 steps) minus
# its byte bound, over the steps: (0.02458 - 0.00989) ms / 1024, on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py phase 3
# prints the fit).
PAGED_STEP_LATENCY_S = 1.434e-8


@dataclass(frozen=True)
class CostTerm:
    """One named addend of the analytic model, queryable by the auditors.

    ``physical`` distinguishes bytes that actually cross the memory
    interface from latency folded into byte currency (the paged-kernel
    dispatch term): a traffic bound derived from the program can only be
    compared against the physical subtotal, never the folded-latency one.
    """

    name: str
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    physical: bool = True


@dataclass
class CostEstimate:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    model_flops: float = 0.0
    # the named addends behind flops / hbm_bytes (empty for measured
    # estimates from roofline_terms: measurement has no decomposition)
    terms: List[CostTerm] = field(default_factory=list)

    def term(self, name: str) -> CostTerm:
        for t in self.terms:
            if t.name == name:
                return t
        return CostTerm(name)

    def physical_hbm_bytes(self) -> float:
        """HBM bytes excluding folded-latency terms — the quantity a
        traffic bound derived from the program can be compared against.
        Falls back to ``hbm_bytes`` when no decomposition is recorded."""
        if not self.terms:
            return self.hbm_bytes
        return sum(t.hbm_bytes for t in self.terms if t.physical)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic overlap model: max of terms (lower bound on step time)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def summary(self) -> str:
        return (
            f"cost/chip: compute={self.compute_s * 1e3:.3f}ms "
            f"memory={self.memory_s * 1e3:.3f}ms "
            f"collective={self.collective_s * 1e3:.3f}ms "
            f"dominant={self.dominant} "
            f"useful_flops={100 * self.useful_flops_ratio:.1f}%"
        )


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    collective_bytes: float,
    chips: int,
    hw: HardwareSpec,
    model_flops: float = 0.0,
    per_chip: bool = False,
) -> CostEstimate:
    """Terms in seconds. ``flops``/``hbm_bytes`` are global unless
    ``per_chip`` (a per-device measurement of an SPMD program)."""
    div = 1 if per_chip else chips
    return CostEstimate(
        compute_s=flops / (div * hw.peak_flops),
        memory_s=hbm_bytes / (div * hw.hbm_bandwidth),
        collective_s=collective_bytes / (div * hw.ici_bandwidth),
        flops=flops / div * chips if per_chip else flops,
        hbm_bytes=hbm_bytes / div * chips if per_chip else hbm_bytes,
        collective_bytes=collective_bytes,
        model_flops=model_flops,
    )


# ---------------------------------------------------------------------------
# Analytic (planner-side) estimators
# ---------------------------------------------------------------------------


def model_flops_per_step(model: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); forward-only kinds
    use 2 N D. Decode processes one token per sequence."""
    n = model.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: 1 new token / sequence


def _attention_flops(model: ModelConfig, shape: InputShape) -> float:
    """Quadratic attention FLOPs not captured by 6ND."""
    pat = model.layer_pattern()
    n_attn = pat.count("a")
    hd = model.num_heads * model.head_dim
    s = shape.seq_len
    if shape.kind == "decode":
        # one query against S cached keys
        win = model.window_size or (model.serve_window if s > 262_144 else s)
        per_layer = 4.0 * shape.global_batch * min(s, win) * hd
        mult = 1.0
    else:
        win = model.window_size or s
        per_layer = 4.0 * shape.global_batch * s * min(s, win) * hd / 2  # causal
        mult = 3.0 if shape.kind == "train" else 1.0
    flops = n_attn * per_layer * mult
    if model.is_encdec and shape.kind != "decode":
        flops += model.encoder_layers * 4.0 * shape.global_batch * model.encoder_seq**2 * hd
    return flops


def decode_attention_traffic(
    model: ModelConfig,
    shape: InputShape,
    kernel: str,
    committed_frac: float = 1.0,
    nb: int = ACT_BYTES,
    donated: bool = True,
) -> float:
    """Decode-attention HBM bytes for one physical operator choice.

    The three operators move very different amounts of cache-sized data
    per decode step (C = committed KV bytes at ``nb`` bytes/element,
    g = query heads per kv head):

    - ``paged``:  the fused kernel streams committed pages straight from
      the slot stack — C * committed_frac, no intermediates.
    - ``gather``: indexing materializes the gathered copy (write) and
      the GQA-expanded copy (write + read) on top of the base stream:
      (2 + 2g) * C, uncommitted bucket slots included regardless of pos.
    - ``ref``:    the oracle path, same shape of traffic in fp32: 2x gather.

    ``donated=False`` adds the full cache write-back C: an un-donated step
    materializes a fresh output copy of the arena every tick, where the
    donated step writes only the new token's slice in place. Kernel
    *selection* never passes it (the write-back is identical for every
    operator, so it cannot move the crossover); the planner's per-plan
    traffic statistic does.
    """
    c = _cache_dense_bytes(model, shape.seq_len, shape.global_batch, nb=nb)
    if kernel == "paged":
        t = c * committed_frac
    else:
        mult = 2.0 + 2.0 * model.q_per_kv
        if kernel == "ref":
            mult *= 2.0
        t = c * mult
    if not donated:
        t += c
    return t


def _paged_grid_steps(model: ModelConfig, shape: InputShape, page: int) -> float:
    """Grid steps per decode step: one per (attn layer, row, kv head, page)."""
    n_attn = model.layer_pattern().count("a")
    pages = -(-_cache_eff_seq(model, shape.seq_len) // page)
    return n_attn * shape.global_batch * model.num_kv_heads * pages


def decode_kernel_seconds(
    model: ModelConfig,
    shape: InputShape,
    hw: HardwareSpec,
    kernel: str,
    page: int,
    committed_frac: float = 1.0,
) -> float:
    """Analytic decode-attention term (seconds) for one operator choice.

    This is the quantity :class:`~repro_torch.core.planner.PlanCompiler` compares
    to *choose* the decode kernel per bucket: page count, window (via the
    effective cached sequence), batch, and head dims all enter.
    """
    t = decode_attention_traffic(model, shape, kernel, committed_frac) / hw.hbm_bandwidth
    if kernel == "paged" and page > 0:
        t += _paged_grid_steps(model, shape, page) * PAGED_STEP_LATENCY_S
    return t


def analytic_cost(
    model: ModelConfig,
    shape: InputShape,
    mesh: MeshConfig,
    plan: PlanConfig,
    hw: HardwareSpec,
    page: int = 0,
    dtype: str = "bfloat16",
) -> CostEstimate:
    """Planner-side cost statistic, decomposed into named :class:`CostTerm`
    addends so an audit can hold each aggregate between bounds derived from
    the program (and exclude the folded-latency dispatch term from traffic
    comparisons). ``dtype`` is the compute dtype the
    byte-sized terms are priced at — the serving stack runs bf16 and fp32
    streams through the same planner, and an fp32 plan moves twice the
    bytes per element."""
    chips = mesh.num_devices
    nb = dtype_bytes(dtype)
    mf = model_flops_per_step(model, shape)
    terms: List[CostTerm] = [CostTerm("model_matmul", flops=mf)]
    attn = _attention_flops(model, shape)
    if attn:
        terms.append(CostTerm("attention", flops=attn))
    if shape.kind == "train" and plan.remat:
        # one extra forward
        terms.append(CostTerm("remat_recompute", flops=(mf + attn) / 3.0))

    p_bytes = model.param_count() * max(PARAM_BYTES, nb)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    terms.append(CostTerm(
        "params_stream", hbm_bytes=p_bytes * (3 if shape.kind == "train" else 1)))
    terms.append(CostTerm(
        "activations",
        hbm_bytes=tokens * model.d_model * nb * model.num_layers * 6))
    terms.append(CostTerm(
        "logits_write", hbm_bytes=tokens * model.vocab_size * nb))
    if shape.kind == "decode":
        terms.append(CostTerm(
            "decode_attention",
            hbm_bytes=decode_attention_traffic(
                model, shape, plan.decode_kernel, nb=nb,
                donated=plan.donate_cache)))
        if plan.decode_kernel == "paged" and page > 0:
            # grid dispatch overhead, folded in as equivalent HBM bytes so
            # the roofline terms stay in one currency — latency, not
            # physical traffic (physical=False keeps it out of traffic
            # bounds derived from the program)
            terms.append(CostTerm(
                "paged_dispatch", physical=False,
                hbm_bytes=_paged_grid_steps(model, shape, page)
                * PAGED_STEP_LATENCY_S * hw.hbm_bandwidth))

    coll = _collective_bytes(model, shape, mesh, plan)
    if coll:
        terms.append(CostTerm("collectives", collective_bytes=coll))
    est = roofline_terms(sum(t.flops for t in terms),
                         sum(t.hbm_bytes for t in terms),
                         coll, chips, hw, model_flops=mf)
    est.terms = terms
    return est


def _collective_bytes(
    model: ModelConfig, shape: InputShape, mesh: MeshConfig, plan: PlanConfig
) -> float:
    """Per-chip collective traffic estimate for the candidate plan."""
    p_bytes = model.param_count() * PARAM_BYTES
    mp = mesh.model_parallelism
    dp = mesh.data_parallelism
    total = 0.0
    if shape.kind == "train" and plan.batch_axes:
        if plan.params_over_data:
            # FSDP: all-gather fwd + all-gather bwd + reduce-scatter grads
            total += 3 * p_bytes / (mp if plan.tensor_parallel else 1)
        else:
            # DP: ring all-reduce of full grads ~ 2x payload
            total += 2 * p_bytes / (mp if plan.tensor_parallel else 1)
    if plan.tensor_parallel:
        tokens_dev = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1) / max(1, dp)
        per_layer = 2 * tokens_dev * model.d_model * ACT_BYTES  # 2 allreduce/layer
        mult = 2 if shape.kind == "train" else 1
        total += model.num_layers * per_layer * mult
    if plan.expert_parallel and model.num_experts:
        tokens_dev = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1) / max(1, dp)
        # all-to-all dispatch + combine, fwd (+bwd for train)
        mult = 4 if shape.kind == "train" else 2
        total += model.num_layers * tokens_dev * model.d_model * ACT_BYTES * mult * (
            model.experts_per_token / max(1, model.experts_per_token)
        )
    return total
