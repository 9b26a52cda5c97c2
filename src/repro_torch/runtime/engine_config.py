"""EngineConfig: the one configuration surface for the serving stack (port
of ``repro/runtime/engine_config.py``, with the reference's fields, defaults
and checks).

``PlanServer`` reads the plan-cache and pool fields, ``ServingEngine`` the
batching fields; the ``launch/serve.py`` argparse maps onto the whole thing
through :meth:`EngineConfig.from_args`.

Two parts of the reference stay out:

- ``donate``: the port's decode step updates the arena in place (the tick is
  one CUDA graph on fixed buffers), so there is nothing to donate and the
  planner always plans for an in-place cache;
- the deprecated per-knob kwargs (``fold_legacy_kwargs``): every class of
  the port takes ``config=`` only.

``build_client`` is the topology decision: the bare engine for
``replicas == 1``, an ``EngineRouter`` over that many replicas above it.
Replicas it builds itself share replica 0's weights: the reference gives
every replica seed-equal weights (one mesh each), and one card holds them
once.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from repro_torch.models.blocks import DECODE_KERNELS


@dataclass(frozen=True)
class EngineConfig:
    """Every serving knob, in one place, grouped by the layer it drives.
    Frozen: a config names a scenario."""

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

    # -- batching / lifecycle (ServingEngine) --------------------------------
    max_group_batch: int = 8
    slo_ms: float = 0.0
    join_mid_decode: bool = True
    # "hol": strict head-of-line bucket pick; "arrival": the pending bucket
    # with the most coalescable rows forms first (bounded deferral keeps
    # the head-of-line bucket starvation-free)
    bucket_select: str = "hol"

    # -- topology (EngineRouter) ---------------------------------------------
    replicas: int = 1
    placement: str = "affinity"       # "affinity" | "load"

    # -- diagnostics ---------------------------------------------------------
    # per-tick structural assertions over pool and engine state
    # (repro_torch.analysis.sanitize); host-side walks, no device sync
    sanitize: bool = False

    def __post_init__(self):
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be float32|bfloat16, got {self.dtype!r}")
        if self.bucket_select not in ("hol", "arrival"):
            raise ValueError(f"bucket_select must be hol|arrival, "
                             f"got {self.bucket_select!r}")
        if self.placement not in ("affinity", "load"):
            raise ValueError(f"placement must be affinity|load, got {self.placement!r}")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
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
        if self.max_group_batch < 1:
            raise ValueError("max_group_batch must be >= 1")
        if self.slo_ms < 0:
            raise ValueError("slo_ms must be >= 0")

    def torch_dtype(self) -> torch.dtype:
        return torch.float32 if self.dtype == "float32" else torch.bfloat16

    @classmethod
    def from_args(cls, args) -> "EngineConfig":
        """Build from an argparse namespace (``launch/serve.py`` flag names).
        Missing attributes keep their config defaults, so partial namespaces
        work too."""
        pick = {f.name: getattr(args, f.name) for f in fields(cls) if hasattr(args, f.name)}
        # a flag whose argparse spelling differs from the field name
        if hasattr(args, "no_cache"):
            pick["enable_cache"] = not args.no_cache
        return cls(**pick)

    # -- construction (function-local imports break the layering cycle:
    # serve_loop and engine import *this* module) ---------------------------
    def build_server(self, model_cfg, mesh_cfg=None, **kw):
        """A ``PlanServer`` over this config; ``kw`` goes to it (``device``,
        ``hw``, ``policy``)."""
        from repro_torch.runtime.serve_loop import PlanServer  # lint: allow-local-import
        return PlanServer(model_cfg, mesh_cfg, config=self, **kw)

    def build_engine(self, server, *, clock=None, **kw):
        from repro_torch.runtime.engine import ServingEngine  # lint: allow-local-import
        return ServingEngine(server, config=self, clock=clock, **kw)

    def build_client(self, model_cfg, mesh_cfg=None, *, servers=None, **kw):
        """The topology decision: one engine for ``replicas == 1``, an
        :class:`~repro_torch.runtime.router.EngineRouter` above that — the
        same ``EngineClient`` surface either way. ``servers``: pre-built
        (warm) PlanServers to wrap instead of constructing fresh ones (one
        per replica); ``kw`` goes to :meth:`build_server`.

        Servers built here hold one copy of the weights: replicas 1..N-1
        take replica 0's tensors through the ``PlanServer.params`` setter,
        so their tokens equal those of the reference's seed-equal replicas.
        Each still initialises its own random weights first (a transient
        copy, freed at the swap), and each replica's planner still counts
        the whole weight bytes in its own statistics, as one mesh per
        replica would hold them."""
        if servers is None:
            servers = [self.build_server(model_cfg, mesh_cfg, **kw)]
            for _ in range(1, self.replicas):
                srv = self.build_server(model_cfg, mesh_cfg, **kw)
                srv.params = servers[0].params
                servers.append(srv)
        if self.replicas <= 1:
            return self.build_engine(servers[0])
        from repro_torch.runtime.router import EngineRouter  # lint: allow-local-import
        return EngineRouter(servers, config=self)
