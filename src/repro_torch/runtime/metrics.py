"""Serving-path counters (port of ``repro/runtime/metrics.py``:
``LatencyStats``, ``serve_summary``, ``pool_summary``; the training step
timer, the scheduler's and the router's metrics come with the paths that
call them).

The plan-cache counters (:class:`PlanCacheMetrics`) live next to the cache
in ``repro_torch.core.plan_cache``; they are re-exported here so the runtime
layer has one metrics surface, and :func:`serve_summary` renders them
together with per-request latency."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

from repro_torch.core.plan_cache import PlanCacheMetrics  # noqa: F401  (re-export)


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
