"""Plan cache + dynamic recompilation for the serving path (port of
``repro/core/plan_cache.py``).

SystemML's compiler is not one-shot: compiled plans carry worst-case
*compile-time statistics* (sizes, sparsity), and the runtime re-optimizes —
*dynamic recompilation* — whenever observed characteristics diverge from
them. This module is the serving-side analogue for the plan compiler.
Mechanism-by-mechanism mapping:

====================================  =====================================
SystemML                              here
====================================  =====================================
plan memoization per operator DAG     :class:`PlanCache`, LRU over
                                      (arch, mesh, dtype, shape-bucket) keys
compile-time statistics               ``ExecutionPlan.memory`` — the worst-
                                      case estimate from ``core.memory``
runtime statistics                    :class:`~repro_torch.core.strategies.RuntimeStats`
                                      (observed shape + live-bytes watermark)
dynamic recompilation                 :meth:`PlanCache.refresh` →
                                      :meth:`PlanCompiler.recompile` when a
                                      request breaches the estimate margin
                                      or outgrows its compiled shape
unknown-size handling via             power-of-two shape buckets
conservative worst-case plans         (:func:`bucket_pow2`): one compiled
                                      plan serves a whole shape family
====================================  =====================================

Without this, every new (batch, context) pair entering ``launch/serve.py``
pays a full planner walk plus a fresh step build (on the card, a CUDA graph
capture per arena); with it, steady-state requests are pure cache hits.
Counters (hits / misses / evictions / compiles / recompiles) are surfaced
through ``repro_torch.runtime.metrics``.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from repro_torch.config import MeshConfig, ModelConfig, InputShape, TrainConfig
from repro_torch.core.strategies import ExecutionPlan, RuntimeStats


# ---------------------------------------------------------------------------
# shape bucketing
# ---------------------------------------------------------------------------


def bucket_pow2(n: int, minimum: int = 1) -> int:
    """Round ``n`` up to the next power of two, at least ``minimum``."""
    n = max(int(n), minimum, 1)
    return 1 << (n - 1).bit_length()


@dataclass(frozen=True)
class BucketPolicy:
    """How incoming request shapes collapse onto cache keys. Small minimum
    buckets avoid one-plan-per-tiny-shape churn at the low end."""

    min_batch: int = 1
    min_seq: int = 16


@dataclass(frozen=True)
class PlanKey:
    """Cache key: one compiled plan per (arch, mesh, dtype, shape-bucket)."""

    arch: str
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    dtype: str
    kind: str                 # "decode" | "prefill" | "train"
    batch_bucket: int
    seq_bucket: int

    @classmethod
    def for_request(
        cls,
        model: ModelConfig,
        mesh: MeshConfig,
        dtype: str,
        shape: InputShape,
        policy: BucketPolicy = BucketPolicy(),
    ) -> "PlanKey":
        return cls(
            arch=model.name,
            mesh_shape=tuple(mesh.shape),
            mesh_axes=tuple(mesh.axis_names),
            dtype=dtype,
            kind=shape.kind,
            batch_bucket=bucket_pow2(shape.global_batch, policy.min_batch),
            seq_bucket=bucket_pow2(shape.seq_len, policy.min_seq),
        )

    def bucket_shape(self) -> InputShape:
        """The shape the bucket's plan is compiled for (covers every request
        that maps to this key)."""
        return InputShape(
            f"{self.kind}_b{self.batch_bucket}x{self.seq_bucket}",
            self.seq_bucket, self.batch_bucket, self.kind,
        )

    def rebucket(self, shape: InputShape,
                 policy: BucketPolicy = BucketPolicy()) -> "PlanKey":
        """Key for an observed shape that may have outgrown this bucket."""
        return dataclasses.replace(
            self,
            batch_bucket=bucket_pow2(shape.global_batch, policy.min_batch),
            seq_bucket=bucket_pow2(shape.seq_len, policy.min_seq),
        )


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


@dataclass
class PlanCacheMetrics:
    """Hit/miss/eviction/compile counters, surfaced via runtime.metrics."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    compiles: int = 0
    recompiles: int = 0
    compile_seconds: float = 0.0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "hits": self.hits, "misses": self.misses,
            "evictions": self.evictions, "compiles": self.compiles,
            "recompiles": self.recompiles, "hit_rate": self.hit_rate,
            "compile_seconds": self.compile_seconds,
        }


@dataclass
class CacheEntry:
    """One compiled plan + its runtime executable for a shape bucket."""

    key: PlanKey
    plan: ExecutionPlan
    step_fn: Any = None            # the bucket's step (runtime.graph_step)
    extras: Dict[str, Any] = field(default_factory=dict)
    hits: int = 0


def recompile_reasons(plan: ExecutionPlan, stats: RuntimeStats,
                      margin: float = 0.25) -> Tuple[str, ...]:
    """Why ``stats`` invalidates ``plan`` (empty tuple = still valid).

    Mirrors SystemML's recompilation predicate: observed characteristics
    exceed the compiled plan's shape, or the measured memory watermark
    exceeds the compile-time estimate by more than ``margin``.
    """
    reasons = []
    if (stats.shape.seq_len > plan.shape.seq_len
            or stats.shape.global_batch > plan.shape.global_batch):
        reasons.append(
            f"shape ({stats.shape.global_batch}x{stats.shape.seq_len}) exceeds "
            f"compiled bucket ({plan.shape.global_batch}x{plan.shape.seq_len})"
        )
    if plan.memory is not None and plan.memory.total > 0 and stats.watermark_bytes:
        limit = plan.memory.total * (1.0 + margin)
        if stats.watermark_bytes > limit:
            mib = 1024 ** 2
            reasons.append(
                f"memory watermark {stats.watermark_bytes / mib:.2f}MiB exceeds "
                f"estimate {plan.memory.total / mib:.2f}MiB by >{margin:.0%}"
            )
    # KV-cache pool breach: the pool's live bytes exceed the compile-time
    # cache statistic the plan was sized for — same predicate shape as the
    # watermark check, scoped to the cache tensor class. With paged arenas
    # both sides are block-granular: the statistic counts provisioned pages
    # (memory.cache_page_count) and the observation counts committed pages,
    # so bucket-shaped slack inside an arena can no longer trip this.
    if stats.cache_pool_bytes and plan.memory is not None:
        kv_est = plan.memory.per_device.get("kv_cache", 0.0)
        if kv_est > 0 and stats.cache_pool_bytes > kv_est * (1.0 + margin):
            mib = 1024 ** 2
            reasons.append(
                f"kv-cache pool {stats.cache_pool_bytes / mib:.2f}MiB exceeds "
                f"planned pool capacity {kv_est / mib:.2f}MiB by >{margin:.0%}"
            )
    return tuple(reasons)


class PlanCache:
    """LRU cache of compiled execution plans keyed by :class:`PlanKey`."""

    def __init__(self, capacity: int = 16,
                 metrics: Optional[PlanCacheMetrics] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.metrics = metrics if metrics is not None else PlanCacheMetrics()
        self._entries: "OrderedDict[PlanKey, CacheEntry]" = OrderedDict()

    # -- dict-ish surface --------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: PlanKey) -> bool:
        return key in self._entries

    def keys(self) -> Iterable[PlanKey]:
        """LRU order: least-recently used first."""
        return list(self._entries.keys())

    def clear(self) -> None:
        self._entries.clear()

    # -- core operations ---------------------------------------------------
    def get(self, key: PlanKey) -> Optional[CacheEntry]:
        entry = self._entries.get(key)
        if entry is None:
            self.metrics.misses += 1
            return None
        self._entries.move_to_end(key)
        entry.hits += 1
        self.metrics.hits += 1
        return entry

    def put(self, key: PlanKey, entry: CacheEntry) -> CacheEntry:
        if key in self._entries:
            self._entries.move_to_end(key)
        self._entries[key] = entry
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.metrics.evictions += 1
        return entry

    def get_or_compile(self, key: PlanKey,
                       compile_fn: Callable[[], CacheEntry]) -> CacheEntry:
        """Hit returns the cached entry; miss runs ``compile_fn`` and
        installs its result (counted as one compile)."""
        entry = self.get(key)
        if entry is None:
            entry = self.put(key, compile_fn())
            self.metrics.compiles += 1
        return entry

    # -- dynamic recompilation --------------------------------------------
    def refresh(
        self,
        key: PlanKey,
        stats: RuntimeStats,
        compiler,
        train: TrainConfig = TrainConfig(),
        margin: float = 0.25,
        build_step: Optional[Callable[[ExecutionPlan], Any]] = None,
        policy: BucketPolicy = BucketPolicy(),
    ) -> Tuple[Optional[CacheEntry], Tuple[str, ...]]:
        """Re-optimize ``key``'s plan if observed ``stats`` invalidate it.

        Returns ``(entry, reasons)``: the (possibly new) entry and the
        recompilation reasons (empty when the cached plan is still valid).
        The new plan is compiled with runtime-corrected statistics via
        :meth:`PlanCompiler.recompile`, so an identical follow-up request
        does **not** trigger a second recompilation — exactly SystemML's
        converge-after-one-recompile behaviour.
        """
        entry = self._entries.get(key)
        if entry is None:
            return None, ()
        reasons = recompile_reasons(entry.plan, stats, margin)
        if not reasons:
            return entry, ()
        new_key = key.rebucket(stats.shape, policy) if any(
            "exceeds compiled bucket" in r for r in reasons) else key
        if new_key != key:
            # grow to the *new bucket* shape so the recompiled plan covers
            # every request that will map to the new key, and drop the
            # invalidated entry — serving it again (or re-refreshing it)
            # would repeat the recompilation forever
            stats = dataclasses.replace(stats, shape=new_key.bucket_shape())
            del self._entries[key]
            existing = self._entries.get(new_key)
            if existing is not None:
                # the target bucket already holds a valid compiled (and
                # possibly captured) plan — reuse it, don't clobber it
                self._entries.move_to_end(new_key)
                return existing, reasons
        new_plan = compiler.recompile(entry.plan, stats, train)
        # same bucket + same layout decisions: only the statistics were
        # corrected, so the already-built step (and its graphs) stays valid
        same_config = (new_key == key
                       and new_plan.config.replace(notes=())
                       == entry.plan.config.replace(notes=()))
        if same_config:
            step_fn = entry.step_fn
        else:
            step_fn = build_step(new_plan) if build_step else None
        new_entry = CacheEntry(key=new_key, plan=new_plan, step_fn=step_fn)
        self.put(new_key, new_entry)
        self.metrics.recompiles += 1
        return new_entry, reasons
