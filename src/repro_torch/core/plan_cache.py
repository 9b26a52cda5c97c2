"""Shape bucketing for the serving path (port of the bucketing part of
``repro/core/plan_cache.py``).

Incoming (batch, context) requests round up to power-of-two buckets, so one
arena shape (and, once the planner is ported, one compiled plan) serves a
whole shape family. The plan cache and dynamic recompilation come with the
planner in slice 2.
"""

from __future__ import annotations

from dataclasses import dataclass


def bucket_pow2(n: int, minimum: int = 1) -> int:
    """Round ``n`` up to the next power of two, at least ``minimum``."""
    n = max(int(n), minimum, 1)
    return 1 << (n - 1).bit_length()


@dataclass(frozen=True)
class BucketPolicy:
    """How incoming request shapes collapse onto buckets. Small minimum
    buckets avoid one-shape-per-tiny-request churn at the low end."""

    min_batch: int = 1
    min_seq: int = 16
