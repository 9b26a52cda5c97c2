"""EngineConfig: the serving configuration (port of
``repro/runtime/engine_config.py``, the fields ``PlanServer`` reads, with
the reference's defaults and checks).

Batching, topology and diagnostics fields come with the engine, scheduler
and router (``ROADMAP.md`` Queue A 9 and 11).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.blocks import DECODE_KERNELS


@dataclass(frozen=True)
class EngineConfig:
    # -- model / plan-cache (PlanServer) -------------------------------------
    dtype: str = "float32"            # "float32" | "bfloat16"
    enable_cache: bool = True
    cache_capacity: int = 16
    recompile_margin: float = 0.25
    seed: int = 0
    prefill: bool = False             # sequential front door's prompt pass

    # -- KV-cache pool (PlanServer -> KVCachePool) ---------------------------
    # arenas the planner's compile-time cache statistics are provisioned for;
    # pool growth past them triggers dynamic recompilation
    pool_arenas: int = 4
    pool_max_arenas: int = 0
    pool_max_bytes: float = 0.0
    page_size: int = 64
    # physical decode-attention operator for paged buckets: "auto" lets the
    # plan compiler choose per bucket from the analytic cost terms; the rest
    # force one operator on every decode plan
    decode_kernel: str = "auto"       # "auto" | "paged" | "gather" | "ref"

    def __post_init__(self):
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be float32|bfloat16, got {self.dtype!r}")
        if self.cache_capacity < 1:
            raise ValueError("cache_capacity must be >= 1")
        if self.recompile_margin < 0:
            raise ValueError("recompile_margin must be >= 0")
        if self.page_size < 0:
            raise ValueError("page_size must be >= 0 (0 = row-granular)")
        if self.decode_kernel not in ("auto",) + DECODE_KERNELS:
            raise ValueError(f"decode_kernel must be auto|{'|'.join(DECODE_KERNELS)}, "
                             f"got {self.decode_kernel!r}")
        if self.pool_arenas < 1:
            raise ValueError("pool_arenas must be >= 1")
        if self.pool_max_arenas < 0 or self.pool_max_bytes < 0:
            raise ValueError("pool caps must be >= 0 (0 = unbounded)")

    def torch_dtype(self) -> torch.dtype:
        return torch.float32 if self.dtype == "float32" else torch.bfloat16
