"""Step metrics and serving-path counters (port of
``repro/runtime/metrics.py``: the training ``StepTimer``, ``LatencyStats``,
``serve_summary``, ``SchedulerMetrics``, ``pool_summary``,
``scheduler_summary``, ``format_metrics``, and the router's
``merge_scheduler_metrics``, ``RouterMetrics`` and ``router_summary``).

The plan-cache counters (:class:`PlanCacheMetrics`) live next to the cache
in ``repro_torch.core.plan_cache``; they are re-exported here so the runtime
layer has one metrics surface, and :func:`serve_summary` renders them
together with per-request latency."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.config import HardwareSpec, InputShape, MeshConfig, ModelConfig
from repro_torch.core.cost import model_flops_per_step
from repro_torch.core.plan_cache import PlanCacheMetrics  # noqa: F401  (re-export)
from repro_torch.hw import H100


@dataclass
class StepTimer:
    """Per-step wall time, throughput and model FLOP utilisation against
    ``hw`` (the port's H100 unless given another spec). CUDA runs
    asynchronously, so :meth:`stop` waits for the card (where this process
    has used it) before it reads the clock."""

    model: Optional[ModelConfig] = None
    shape: Optional[InputShape] = None
    mesh: Optional[MeshConfig] = None
    hw: HardwareSpec = H100
    history: List[Dict] = field(default_factory=list)
    _t0: float = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int, metrics: Dict) -> Dict:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        rec = {"step": step, "seconds": dt}
        rec.update({k: float(v) for k, v in metrics.items()})
        if self.model is not None and self.shape is not None:
            flops = model_flops_per_step(self.model, self.shape)
            rec["tokens_per_s"] = self.shape.global_batch * self.shape.seq_len / dt
            if self.mesh is not None:
                rec["mfu"] = flops / dt / (self.mesh.num_devices * self.hw.peak_flops)
        self.history.append(rec)
        return rec

    def summary(self) -> Dict:
        if not self.history:
            return {}
        n = len(self.history)
        keys = self.history[-1].keys()
        return {k: sum(h.get(k, 0.0) for h in self.history) / n
                for k in keys if k != "step"}


@dataclass
class LatencyStats:
    """Per-request latency accumulator for the serving stream."""

    samples: List[float] = field(default_factory=list)

    def record(self, seconds: float) -> None:
        self.samples.append(float(seconds))

    @property
    def count(self) -> int:
        return len(self.samples)

    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    def percentile(self, q: float) -> float:
        """Ceil-based nearest-rank percentile: the smallest sample with at
        least ``q``% of the distribution at or below it. The previous
        ``int(round(q/100 * (n-1)))`` indexing went through Python's
        banker's rounding, which on small sample counts rounds half-way
        ranks *down* to the even index — flattering p50/p95 by picking the
        lower sample. Nearest-rank never reports below the true rank."""
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        idx = min(len(xs) - 1, max(0, math.ceil(q / 100.0 * len(xs)) - 1))
        return xs[idx]

    def summary(self) -> str:
        ms = 1e3
        return (f"requests={self.count} mean={self.mean() * ms:.2f}ms "
                f"p50={self.percentile(50) * ms:.2f}ms "
                f"p95={self.percentile(95) * ms:.2f}ms")


def serve_summary(cache: PlanCacheMetrics, latency: LatencyStats) -> str:
    """One-line serving report: plan-cache counters + request latency."""
    return (f"plan_cache: hits={cache.hits} misses={cache.misses} "
            f"evictions={cache.evictions} compiles={cache.compiles} "
            f"recompiles={cache.recompiles} hit_rate={cache.hit_rate:.2f} "
            f"compile_s={cache.compile_seconds:.2f}  |  {latency.summary()}")


@dataclass
class SchedulerMetrics:
    """Continuous-batching accounting: queueing vs. execution latency per
    request, coalescing effectiveness, and SLO attainment.

    ``slo_s`` is the per-request total-latency objective (admission to last
    token); 0 disables SLO accounting. ``batch_slots_used`` /
    ``batch_slots_total`` measure how well coalescing fills each group's
    batch-bucket capacity (the anti-padding story: sequential serving pads
    every request up to its own bucket alone)."""

    slo_s: float = 0.0
    admitted: int = 0
    completed: int = 0
    groups: int = 0
    coalesced_requests: int = 0     # requests that shared a group
    joins: int = 0                  # requests absorbed mid-decode
    join_rows: int = 0              # arena rows filled by mid-decode joins
    peak_resident: int = 0          # max concurrently in-flight requests
    batch_slots_used: int = 0       # sum of member request batches
    batch_slots_total: int = 0      # sum of group batch-bucket capacities
    cancelled: int = 0              # requests terminated by cancel()
    early_exits: int = 0            # completed before max_tokens (eos/stop)
    slo_met: int = 0
    slo_missed: int = 0
    queue_latency: LatencyStats = field(default_factory=LatencyStats)
    exec_latency: LatencyStats = field(default_factory=LatencyStats)
    total_latency: LatencyStats = field(default_factory=LatencyStats)
    # streaming-consumer latencies: admission -> first token, and the gap
    # between consecutive token events of one request
    ttft_latency: LatencyStats = field(default_factory=LatencyStats)
    itl_latency: LatencyStats = field(default_factory=LatencyStats)

    @property
    def bucket_fill(self) -> float:
        """Fraction of coalesced batch-bucket slots holding real requests."""
        return (self.batch_slots_used / self.batch_slots_total
                if self.batch_slots_total else 0.0)

    @property
    def slo_attainment(self) -> float:
        judged = self.slo_met + self.slo_missed
        return self.slo_met / judged if judged else 1.0

    def observe_group(self, member_batches, bucket_batch: int) -> None:
        self.groups += 1
        if len(member_batches) > 1:
            self.coalesced_requests += len(member_batches)
        self.batch_slots_used += sum(member_batches)
        self.batch_slots_total += bucket_batch

    def observe_joins(self, member_batches) -> None:
        """Mid-decode joins: requests absorbed into free rows of an
        in-flight group. Tracked separately from ``bucket_fill`` — that
        ratio stays an admission-time fill fraction (<= 1.0); joins reuse
        slots the group already paid for, and their utilization shows up
        in the pool occupancy line instead."""
        self.joins += len(member_batches)
        self.join_rows += sum(member_batches)

    def observe_resident(self, live_requests: int) -> None:
        """Track the peak number of concurrently in-flight requests — the
        residency the pool budget actually admitted (the paged-vs-dense
        fragmentation benchmark gates on this)."""
        self.peak_resident = max(self.peak_resident, live_requests)

    def observe_first_token(self, ttft_s: float) -> None:
        """Time-to-first-token: request admission to its first TokenEvent
        (the latency a streaming consumer actually perceives)."""
        self.ttft_latency.record(ttft_s)

    def observe_token_gap(self, gap_s: float) -> None:
        """Inter-token latency: gap between consecutive token events of
        one request (steady-state streaming cadence)."""
        self.itl_latency.record(gap_s)

    def observe_request(self, queue_s: float, exec_s: float) -> None:
        self.completed += 1
        total = queue_s + exec_s
        self.queue_latency.record(queue_s)
        self.exec_latency.record(exec_s)
        self.total_latency.record(total)
        if self.slo_s > 0:
            if total <= self.slo_s:
                self.slo_met += 1
            else:
                self.slo_missed += 1

    def summary(self) -> str:
        ms = 1e3
        line = (f"scheduler: admitted={self.admitted} "
                f"completed={self.completed} groups={self.groups} "
                f"coalesced={self.coalesced_requests} "
                f"joins={self.joins} join_rows={self.join_rows} "
                f"peak_resident={self.peak_resident} "
                f"bucket_fill={self.bucket_fill:.2f}  |  "
                f"queue p50={self.queue_latency.percentile(50) * ms:.1f}ms "
                f"p95={self.queue_latency.percentile(95) * ms:.1f}ms  "
                f"exec p50={self.exec_latency.percentile(50) * ms:.1f}ms "
                f"p95={self.exec_latency.percentile(95) * ms:.1f}ms")
        if self.ttft_latency.count:
            line += (f"  |  ttft p50={self.ttft_latency.percentile(50) * ms:.1f}ms "
                     f"p95={self.ttft_latency.percentile(95) * ms:.1f}ms  "
                     f"itl p50={self.itl_latency.percentile(50) * ms:.1f}ms "
                     f"p95={self.itl_latency.percentile(95) * ms:.1f}ms")
        if self.cancelled or self.early_exits:
            line += (f"  |  cancelled={self.cancelled} "
                     f"early_exits={self.early_exits}")
        if self.slo_s > 0:
            line += (f"  |  slo<{self.slo_s * ms:.0f}ms: "
                     f"met={self.slo_met} missed={self.slo_missed} "
                     f"attainment={self.slo_attainment:.2f}")
        return line


def merge_scheduler_metrics(parts) -> "SchedulerMetrics":
    """Fleet rollup: one :class:`SchedulerMetrics` summing N replicas'
    counters and pooling their latency samples (percentiles over the
    merged distribution, not averages of per-replica percentiles — an
    idle replica must not dilute a hot one's p95). ``peak_resident`` sums
    per-replica peaks: an upper bound on fleet-wide concurrent residency
    (the peaks need not have coincided)."""
    parts = list(parts)
    out = SchedulerMetrics(slo_s=parts[0].slo_s if parts else 0.0)
    for m in parts:
        for name in ("admitted", "completed", "groups", "coalesced_requests", "joins",
                     "join_rows", "peak_resident", "batch_slots_used", "batch_slots_total",
                     "cancelled", "early_exits", "slo_met", "slo_missed"):
            setattr(out, name, getattr(out, name) + getattr(m, name))
        for name in ("queue_latency", "exec_latency", "total_latency", "ttft_latency",
                     "itl_latency"):
            getattr(out, name).samples.extend(getattr(m, name).samples)
    return out


@dataclass
class RouterMetrics:
    """EngineRouter accounting: where requests were placed and why, plus
    the failover counters (``resubmitted`` requests moved off ``drained``
    replicas with zero loss)."""

    placements: Dict[str, int] = field(default_factory=dict)
    failovers: int = 0             # drain_replica invocations
    resubmitted: int = 0           # live requests moved to survivors
    drained: int = 0               # replicas currently draining

    def observe_placement(self, reason: str) -> None:
        self.placements[reason] = self.placements.get(reason, 0) + 1

    def summary(self) -> str:
        placed = ",".join(f"{k}={v}" for k, v in sorted(self.placements.items()))
        return (f"placements[{placed}] failovers={self.failovers} "
                f"resubmitted={self.resubmitted} drained={self.drained}")


def router_summary(router) -> str:
    """Multi-line fleet report: one line per replica (its scheduler
    counters, TTFT tail, and device-clock time), that replica's KV-pool
    line, then the fleet rollup over the merged metrics."""
    ms = 1e3
    lines = [f"router: replicas={len(router.replicas)} "
             f"placement={router.config.placement} "
             f"{router.router_metrics.summary()}"]
    for r in router.replicas:
        m = r.engine.metrics
        flag = " DRAINING" if r.draining else ""
        lines.append(
            f"replica[{r.idx}]{flag}: admitted={m.admitted} "
            f"completed={m.completed} groups={m.groups} joins={m.joins} "
            f"ttft_p95={m.ttft_latency.percentile(95) * ms:.1f}ms "
            f"device_t={r.clock.now():.3f}s")
        lines.append("  " + pool_summary(r.server.pool).replace("\n", "\n  "))
    lines.append("fleet: " + merge_scheduler_metrics(
        [r.engine.metrics for r in router.replicas]).summary())
    return "\n".join(lines)


def pool_summary(pool) -> str:
    """KV-cache pool report (``repro_torch.runtime.kv_cache``): arena churn, row
    reuse, live occupancy — plus, for paged pools, page churn and internal
    fragmentation (slack inside leased pages)."""
    m = pool.metrics
    mib = 1024 ** 2
    line = (f"kv_pool: arenas={m.arenas_created} reused={m.arenas_reused} "
            f"denied={m.arenas_denied} rows={m.rows_leased} "
            f"rows_reused={m.rows_reused} handoffs={m.handoff_writes} "
            f"occupancy={pool.occupancy():.2f} "
            f"live={pool.live_bytes() / mib:.1f}MiB "
            f"peak={m.peak_bytes / mib:.1f}MiB")
    if getattr(pool, "paged", False):
        line += (f"\nkv_pages: size={pool.page_size} "
                 f"leased={m.pages_leased} freed={m.pages_freed} "
                 f"denied={m.pages_denied} reclaimed={m.pages_reclaimed} "
                 f"peak={m.peak_pages} live={pool.pages_live()} "
                 f"frag={1.0 - pool.slot_utilization():.2f}")
    return line


def scheduler_summary(sched: "SchedulerMetrics", cache: PlanCacheMetrics,
                      latency: LatencyStats, pool=None) -> str:
    """Scheduler accounting, optional KV-pool line, plan-cache line."""
    lines = [sched.summary()]
    if pool is not None:
        lines.append(pool_summary(pool))
    lines.append(serve_summary(cache, latency))
    return "\n".join(lines)


def format_metrics(rec: Dict) -> str:
    parts = []
    for k, v in rec.items():
        if isinstance(v, float):
            parts.append(f"{k}={v:.4g}")
        else:
            parts.append(f"{k}={v}")
    return "  ".join(parts)
