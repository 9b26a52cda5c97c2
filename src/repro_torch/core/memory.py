"""Worst-case memory estimation (paper §3, "Distributed Operations"; port of
``repro/core/memory.py``, the same arithmetic).

SystemML compiles a single-node plan "if the input, output and intermediate
matrices fit in the driver JVM" and escalates to a distributed plan
otherwise. The estimator here plays the same role for a device mesh: given a
(model x shape x mesh) and a candidate :class:`PlanConfig`, compute the
worst-case **per-device memory bytes** for every tensor class. The planner
escalates through the plan lattice until the estimate fits the budget
(``HardwareSpec.hbm_bytes``).

Estimates are deliberately *worst-case* (SystemML's estimator is too): they
must never under-estimate, or a "fitting" plan OOMs at runtime.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.config import HardwareSpec, InputShape, MeshConfig, ModelConfig, TrainConfig
from repro_torch.core.strategies import PlanConfig
from repro_torch.hw import H100
from repro_torch.kernels import rglru_scan as RGLRU
from repro_torch.kernels import ssd_scan as SSD

ACT_BYTES = 2       # bf16 default (cost-model roofline terms)
PARAM_BYTES = 2     # bf16 default

# serving/training dtype -> bytes per element. The estimator threads the
# *actual* compute dtype through every tensor class instead of assuming
# bf16: an fp32 server's first estimate must already be fp32-sized, or the
# first request in every bucket burns a corrective recompile.
DTYPE_BYTES = {
    "float64": 8,
    "float32": 4,
    "bfloat16": 2,
    "float16": 2,
    "float8_e4m3fn": 1,
    "float8_e5m2": 1,
    "int8": 1,
}


def dtype_bytes(dtype: str) -> int:
    """Bytes per element for a dtype name (worst-case 4 for unknown names:
    the estimator must never under-estimate)."""
    return DTYPE_BYTES.get(str(dtype), 4)

# The H100's terms. The port's prompt pass on the card runs op by op (eager
# PyTorch, no fusion): every elementwise intermediate of a layer is
# materialized, in float32 where the model computes in float32, so a
# layer's working set takes EAGER_WORKING_BYTES a column whatever the model
# dtype, and the SSD block, which also keeps x, B and C in float32 beside
# their model-dtype copies for the handoff state, EAGER_SSD_FACTOR times
# that. chip_smoke.py's analysis phase measures it (on an H100 80GB HBM3
# at 700 W, Mamba-2 1.3B's (8, 2048) prompt pass held 2.40 GiB above its
# inputs where the fused terms give 1.21). Every other HardwareSpec keeps
# the reference's (XLA-fused) terms, so the planner equals the reference's
# on its figures.
EAGER_WORKING_BYTES = 4
EAGER_SSD_FACTOR = 1.5
# The H100's training terms. The float32 cross-entropy
# (models/common.py::softmax_xent_logits) keeps a float32 copy of the logits
# for its backward, which forms the softmax and the logits' gradient in
# float32 beside it: XENT_BYTES a logit on top of the model-dtype logits
# the activations count (25 GB at recurrentgemma-2b's 8192 x 256,000).
# The recurrent layers' backward kernels add, per layer whose activations
# are live, the state their training forward keeps (SSD: each chunk's
# starting state, float32 (B, H, S / 64, P, N); RG-LRU: the state entering
# each chunk of 8 positions, float32 (B, S / 8, W)) and, for the one layer
# in its backward, its scratch (SSD: per-head dB and dC, float32
# (B, H, S, N) each, and C B^T per chunk; RG-LRU: per-row dc).
XENT_BYTES = 12

# optimizer -> number of per-param state slots (repro_torch.nn.optim)
OPTIMIZER_SLOTS = {
    "sgd": 0,
    "sgd_momentum": 1,
    "sgd_nesterov": 1,
    "adagrad": 1,
    "rmsprop": 1,
    "adam": 2,
}


@dataclass
class MemoryEstimate:
    per_device: Dict[str, float] = field(default_factory=dict)
    budget: int = 0

    @property
    def total(self) -> float:
        return sum(self.per_device.values())

    def fits(self, headroom: float = 0.9) -> bool:
        return self.total <= self.budget * headroom

    def scaled(self, factor: float) -> "MemoryEstimate":
        """Runtime-corrected copy: every tensor-class estimate multiplied by
        the observed/estimated correction factor. Dynamic recompilation
        replaces compile-time worst-case statistics with these."""
        return MemoryEstimate(
            per_device={k: v * factor for k, v in self.per_device.items()},
            budget=self.budget,
        )

    def summary(self) -> str:
        gib = 1024**3
        parts = "  ".join(f"{k}={v / gib:.2f}GiB" for k, v in self.per_device.items())
        return (
            f"memory/chip: total={self.total / gib:.2f}GiB "
            f"budget={self.budget / gib:.1f}GiB fits={self.fits()}  [{parts}]"
        )


def _opt_bytes_per_param(optimizer: str, opt_dtype: str) -> float:
    slots = OPTIMIZER_SLOTS.get(optimizer, 2)
    slot_bytes = 4 if opt_dtype == "float32" else 2
    # fp32 master copy kept only with fp32 optimizer state (mixed precision)
    master = 4 if opt_dtype == "float32" else 0
    return slots * slot_bytes + master


def _param_divisors(plan: PlanConfig, mesh: MeshConfig) -> float:
    div = 1.0
    if plan.tensor_parallel or plan.expert_parallel:
        div *= mesh.model_parallelism
    if plan.params_over_data:
        div *= mesh.data_parallelism
    return div


def estimate_memory(
    model: ModelConfig,
    shape: InputShape,
    mesh: MeshConfig,
    plan: PlanConfig,
    train: TrainConfig,
    hw: HardwareSpec,
    dtype: str = "bfloat16",
    cache_pool_arenas: int = 1,
    cache_pages: int = 0,
    cache_page_size: int = 0,
    donate_cache: bool = True,
) -> MemoryEstimate:
    """``dtype`` is the actual compute dtype (params + activations + grads +
    KV cache); compile-time statistics follow it instead of assuming bf16.

    ``cache_pool_arenas`` sizes the decode KV-cache statistic for a
    row-addressable cache pool (``repro_torch.runtime.kv_cache``) provisioned for
    that many concurrent bucket arenas; 1 is the single-blob behaviour. The
    pool's live bytes at runtime are checked against this compile-time
    statistic by the dynamic-recompilation predicate.

    ``cache_pages``/``cache_page_size`` switch the decode cache statistic
    to block granularity: the attention K/V term is sized as ``cache_pages``
    fixed-size pages (what a paged pool can physically commit — see
    :func:`cache_page_count`) instead of ``arenas x bucket`` dense blobs,
    while per-row recurrent state still scales with the arena count. The
    paged pool's page-exact live bytes are compared against exactly this.

    ``donate_cache=False`` charges the ``kv_double_buffer`` class: a step
    compiled without buffer donation transiently holds a second full copy
    of the group's arena (the output cache next to the input one). Donated
    plans — the default — update in place. The port's decode step always
    updates in place; the flag keeps the statistics the reference's."""
    nb = dtype_bytes(dtype)
    est = MemoryEstimate(budget=hw.hbm_bytes)
    p = model.param_count()
    # ~1.5% of params (norm scales, biases, router, A/dt vectors) do not shard
    # over the model axis; they still shard over data under FSDP.
    non_shardable = max(0.015 * p, 2 * model.d_model * model.num_layers)
    shardable = p - non_shardable

    mp = mesh.model_parallelism if (plan.tensor_parallel or plan.expert_parallel) else 1
    dp_div = mesh.data_parallelism if plan.params_over_data else 1

    params_dev = (shardable / (mp * dp_div) + non_shardable / dp_div) * nb
    est.per_device["params"] = params_dev

    dp = mesh.data_parallelism if plan.batch_axes else 1

    if shape.kind == "train":
        est.per_device["grads"] = params_dev
        est.per_device["opt_state"] = (
            params_dev / nb * _opt_bytes_per_param(train.optimizer, plan.opt_state_dtype)
        )
        est.per_device["activations"] = _train_activation_bytes(model, shape, plan, dp, mp, nb)
        if hw.name == H100.name:
            tok = max(1, shape.global_batch // dp) // plan.microbatches * shape.seq_len
            est.per_device["xent"] = tok * (model.vocab_size / mp) * XENT_BYTES
            est.per_device["recurrent_backward"] = _recurrent_backward_bytes(model, shape, plan,
                                                                             dp)
    elif shape.kind == "prefill":
        est.per_device["activations"] = _prefill_activation_bytes(
            model, shape, plan, dp, mp, nb, eager=hw.name == H100.name)
    else:  # decode
        if cache_pages and cache_page_size:
            est.per_device["kv_cache"] = _cache_paged_bytes(
                model, shape, plan, mesh, nb, cache_pages, cache_page_size,
                max(1, cache_pool_arenas))
        else:
            est.per_device["kv_cache"] = (max(1, cache_pool_arenas)
                                          * _cache_bytes(model, shape, plan, mesh, nb))
        if not donate_cache:
            # un-donated tick: the step's cache output is a fresh buffer
            # the size of one full arena (paged output stacks allocate at
            # capacity regardless of page commitment), live next to the
            # input copy until the arena re-adopts it
            est.per_device["kv_double_buffer"] = _cache_bytes(
                model, shape, plan, mesh, nb)
        est.per_device["activations"] = _decode_activation_bytes(model, shape, dp, mp, nb)

    est.per_device["workspace"] = 0.08 * sum(est.per_device.values())
    return est


# ---------------------------------------------------------------------------
# per-kind activation estimates
# ---------------------------------------------------------------------------


def _layer_working_cols(model: ModelConfig, mp: int, variant: str) -> float:
    """Per-token working-set width (columns) of one layer's live tensors,
    assuming flash attention (no S^2 score materialization)."""
    d = model.d_model
    cols = 4.0 * d  # residual stream, norm output, block in/out
    pat = model.layer_pattern()
    # use the widest layer kind present (worst case)
    widths = []
    for kind in set(pat):
        if kind == "a":
            qkv = model.num_heads * model.head_dim + 2 * model.num_kv_heads * model.head_dim
            ffn = 3 * model.d_ff
            moe_expand = 0.0
            if model.num_experts:
                # top-k routed expert activations per token (model-sharded)
                ffn = 3 * model.d_ff * model.experts_per_token + model.num_experts
                # dispatch expansion: k copies of each token's d_model row in
                # the (tokens*k, d) gather buffers — NOT model-sharded, and
                # several live at once through fwd+bwd (x4)
                moe_expand = 4.0 * model.experts_per_token * d
            widths.append((qkv + ffn) / mp + 2 * model.num_heads * model.head_dim / mp
                          + moe_expand)
        elif kind == "s":
            widths.append((2 * model.d_inner + 2 * model.ssm_state + model.ssm_num_heads) / mp + model.d_inner / mp)
        elif kind == "r":
            w = model.lru_width or d
            widths.append(4.0 * w / mp)
    return cols + (max(widths) if widths else 0.0)


def _train_activation_bytes(
    model: ModelConfig, shape: InputShape, plan: PlanConfig, dp: int, mp: int,
    nb: int = ACT_BYTES,
) -> float:
    b_dev = max(1, shape.global_batch // dp)
    b_micro = max(1, b_dev // plan.microbatches)
    s = shape.seq_len
    tok = b_micro * s
    if plan.remat:
        # scan carries one residual-stream checkpoint per layer + one layer's
        # recomputation working set + logits chunk
        ckpt_div = mp if plan.seq_shard_checkpoints else 1
        saved = model.num_layers * tok * model.d_model * nb / ckpt_div
        working = tok * _layer_working_cols(model, mp, plan.attention_variant) * nb
    else:
        saved = model.num_layers * tok * _layer_working_cols(model, mp, plan.attention_variant) * nb
        working = 0.0
    # loss computed over vocab shard (vocab is model-sharded under TP)
    logits = tok * (model.vocab_size / mp) * nb
    if model.is_encdec:
        enc_tok = b_micro * model.encoder_seq
        saved += model.encoder_layers * enc_tok * model.d_model * nb
    return saved + working + logits


def _recurrent_backward_bytes(model: ModelConfig, shape: InputShape, plan: PlanConfig,
                              dp: int) -> float:
    """The recurrent layers' backward terms on the H100 (see XENT_BYTES):
    the saved states of one layer under remat (of every such layer without
    it) plus one layer's backward scratch, for the larger of the SSD and
    RG-LRU kinds the pattern holds. Each kind's bytes are its kernel
    module's ``train_bytes``, from the shapes its wrappers allocate."""
    b = max(1, max(1, shape.global_batch // dp) // plan.microbatches)
    s = shape.seq_len
    pat = model.layer_pattern()
    terms = [0.0]
    if "s" in pat:
        saved, scratch = SSD.train_bytes(b, s, model.ssm_num_heads, model.ssm_head_dim,
                                         model.ssm_state)
        terms.append(saved * (1 if plan.remat else pat.count("s")) + scratch)
    if "r" in pat:
        saved, scratch = RGLRU.train_bytes(b, s, model.lru_width or model.d_model)
        terms.append(saved * (1 if plan.remat else pat.count("r")) + scratch)
    return float(max(terms))


def _prefill_activation_bytes(
    model: ModelConfig, shape: InputShape, plan: PlanConfig, dp: int, mp: int,
    nb: int = ACT_BYTES, eager: bool = False,
) -> float:
    """``eager``: the H100's terms, the working set of a prompt pass run op
    by op."""
    b_dev = max(1, shape.global_batch // dp)
    # context parallelism: seq dim itself sharded (KV all-gathered per layer)
    sp = mp if plan.seq_axes else 1
    tok = b_dev * shape.seq_len // sp
    # forward-only: a few live layer boundaries + one working set + the
    # KV cache being produced
    live = 3 * tok * model.d_model * nb
    working = tok * _layer_working_cols(model, mp, plan.attention_variant) * nb
    if eager:
        ssd = EAGER_SSD_FACTOR if "s" in model.layer_pattern() else 1.0
        working *= EAGER_WORKING_BYTES / nb * ssd
    kv = _cache_dense_bytes(model, shape.seq_len, b_dev, nb) / (
        mp if (plan.tensor_parallel or plan.seq_axes) else 1)
    if plan.seq_axes:
        # one layer's all-gathered K/V working copy
        working += b_dev * shape.seq_len * 2 * model.num_kv_heads * model.head_dim * nb
    logits = b_dev * max(1, model.vocab_size // mp) * nb  # last-token logits
    return live + working + kv + logits


def _decode_activation_bytes(model: ModelConfig, shape: InputShape, dp: int, mp: int,
                             nb: int = ACT_BYTES) -> float:
    b_dev = max(1, shape.global_batch // dp)
    per_tok = _layer_working_cols(model, mp, "full") + model.vocab_size / mp
    return b_dev * per_tok * nb * 4  # x4: double-buffering + fudge


# ---------------------------------------------------------------------------
# KV / recurrent-state cache
# ---------------------------------------------------------------------------


def _cache_dense_bytes(model: ModelConfig, seq: int, batch: int,
                       nb: int = ACT_BYTES) -> float:
    """Un-sharded cache bytes for one full attention stack: the attention
    K/V slots plus the sequence-O(1) recurrent/cross state — the same two
    terms the paged estimate sizes, so dense and paged statistics can never
    drift apart."""
    return (batch * _cache_eff_seq(model, seq) * _kv_slot_bytes(model, nb)
            + _cache_recurrent_bytes(model, batch, nb))


def _cache_eff_seq(model: ModelConfig, seq: int) -> int:
    """Cache slots per attention row for a ``seq`` context (window-aware)."""
    if model.window_size:
        return min(seq, model.window_size)
    if model.serve_window and seq > 262_144:
        return min(seq, model.serve_window)
    return seq


def _kv_slot_bytes(model: ModelConfig, nb: int = ACT_BYTES) -> float:
    """Bytes of one K/V cache slot across every attention layer."""
    kv_width = 2 * model.num_kv_heads * model.head_dim
    return model.layer_pattern().count("a") * kv_width * nb


def _cache_recurrent_bytes(model: ModelConfig, batch: int,
                           nb: int = ACT_BYTES) -> float:
    """Per-arena bytes of the sequence-O(1) cache entries (SSD state, conv
    tails, RG-LRU state, enc-dec cross K/V) — the part paging cannot touch."""
    total = 0.0
    for kind in model.layer_pattern():
        if kind == "s":
            st = model.ssm_num_heads * model.ssm_head_dim * model.ssm_state
            conv = model.ssm_conv_width * (model.d_inner + 2 * model.ssm_state)
            total += batch * (st + conv) * nb
        elif kind == "r":
            w = model.lru_width or model.d_model
            total += batch * w * 4  # RG-LRU state kept fp32 regardless
    if model.is_encdec:
        kv_width = 2 * model.num_kv_heads * model.head_dim
        total += model.num_layers * batch * model.encoder_seq * kv_width * nb
    return total


def cache_page_count(model: ModelConfig, seq: int, batch: int,
                     page: int) -> int:
    """Physical pages one (batch, seq) paged arena provisions:
    ``batch * ceil(eff_seq / page)`` (0 for families with no attention)."""
    if page <= 0 or model.layer_pattern().count("a") == 0:
        return 0
    return batch * -(-_cache_eff_seq(model, seq) // page)


def _cache_divisors(model: ModelConfig, shape: InputShape, plan: PlanConfig,
                    mesh: MeshConfig):
    batch_div = 1
    for ax, sz in zip(mesh.axis_names, mesh.shape):
        if ax in plan.cache_batch_axes:
            batch_div *= sz
    batch_div = min(batch_div, shape.global_batch)
    div = 1
    if plan.cache_heads_over_model:
        div *= mesh.model_parallelism
    for ax, sz in zip(mesh.axis_names, mesh.shape):
        if ax in plan.cache_seq_axes:
            div *= sz
    return batch_div, div


def _cache_bytes(model: ModelConfig, shape: InputShape, plan: PlanConfig, mesh: MeshConfig,
                 nb: int = ACT_BYTES) -> float:
    batch_div, div = _cache_divisors(model, shape, plan, mesh)
    b = max(1, shape.global_batch // batch_div)
    return _cache_dense_bytes(model, shape.seq_len, b, nb) / div


def _cache_paged_bytes(model: ModelConfig, shape: InputShape, plan: PlanConfig,
                       mesh: MeshConfig, nb: int, pages: int, page: int,
                       arenas: int) -> float:
    """Worst-case per-chip bytes of a block-granular cache pool provisioned
    with ``pages`` physical pages (across all arenas) plus ``arenas`` worth
    of per-row recurrent state. Shards like the dense cache estimate."""
    batch_div, div = _cache_divisors(model, shape, plan, mesh)
    b = max(1, shape.global_batch // batch_div)
    page_frac = b / max(1, shape.global_batch)   # pages follow the batch shard
    attn = pages * page_frac * page * _kv_slot_bytes(model, nb)
    rec = arenas * _cache_recurrent_bytes(model, b, nb)
    return (attn + rec) / div
