"""EngineConfig: the serving configuration (port of
``repro/runtime/engine_config.py``, the fields ``PlanServer`` reads).

Batching, topology and diagnostics fields come with the engine, scheduler
and router in slice 2. ``decode_kernel="auto"`` — the planner choosing the
decode-attention operator per bucket — waits for the planner there too.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.blocks import DECODE_KERNELS


@dataclass(frozen=True)
class EngineConfig:
    # -- model ---------------------------------------------------------------
    dtype: str = "float32"            # "float32" | "bfloat16"
    seed: int = 0
    prefill: bool = False             # sequential front door's prompt pass

    # -- KV-cache pool (PlanServer -> KVCachePool) ---------------------------
    # arenas the planner's compile-time cache statistics are provisioned for
    # (read by the planner once slice 2 ports it)
    pool_arenas: int = 4
    pool_max_arenas: int = 0
    pool_max_bytes: float = 0.0
    page_size: int = 64
    # physical decode-attention operator for paged buckets
    decode_kernel: str = "paged"      # "paged" | "gather" | "ref"

    def __post_init__(self):
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be float32|bfloat16, got {self.dtype!r}")
        if self.page_size < 0:
            raise ValueError("page_size must be >= 0 (0 = row-granular)")
        if self.decode_kernel == "auto":
            raise NotImplementedError(
                "decode_kernel='auto' needs the plan compiler, which slice 2 of "
                "the PyTorch port brings; pick one of " + "|".join(DECODE_KERNELS))
        if self.decode_kernel not in DECODE_KERNELS:
            raise ValueError(f"decode_kernel must be one of {DECODE_KERNELS}, "
                             f"got {self.decode_kernel!r}")
        if self.pool_arenas < 1:
            raise ValueError("pool_arenas must be >= 1")
        if self.pool_max_arenas < 0 or self.pool_max_bytes < 0:
            raise ValueError("pool caps must be >= 0 (0 = unbounded)")

    def torch_dtype(self) -> torch.dtype:
        return torch.float32 if self.dtype == "float32" else torch.bfloat16
