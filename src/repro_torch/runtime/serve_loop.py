"""Serving runtime: prefill + paged decode under a plan (port of
``repro/runtime/serve_loop.py``).

:class:`PlanServer` is the dynamic-recompilation serving session: requests
round up to power-of-two (batch, span) buckets, each bucket's plan and step
live in a :class:`~repro_torch.core.plan_cache.PlanCache` entry, and the
observed runtime statistics feed back into the plan compiler when they
breach the plan's compile-time estimates. On the card each decode entry's
step is one CUDA graph per arena (``runtime.graph_step``); prefill entries
hold the eager prompt pass.

:meth:`PlanServer.handle` serves one request synchronously as a thin
submit-and-drain adapter over
:class:`~repro_torch.runtime.engine.ServingEngine`, the one request-lifecycle
implementation, configured for the sequential shape: wall-clock time, no
mid-decode joins, whole-span pages committed at admission, no wait for the
device between ticks.
"""

from __future__ import annotations

import functools
import itertools
import time
import weakref
from dataclasses import dataclass, field
from dataclasses import replace as dc_replace
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import (SINGLE_DEVICE_MESH, HardwareSpec, InputShape, MeshConfig,
                                ModelConfig)
from repro_torch.core.plan_cache import (BucketPolicy, CacheEntry, PlanCache, PlanKey,
                                         bucket_pow2)
from repro_torch.core.planner import PlanCompiler
from repro_torch.core.sharding import tree_shardings, tree_specs
from repro_torch.core.strategies import ExecutionPlan, PlanConfig, RuntimeStats
from repro_torch.hw import H100
from repro_torch.launch.mesh import TracedMesh, axes_group, mesh_groups
from repro_torch.models.common import ShardCtx
from repro_torch.models.model import build_model
from repro_torch.runtime.engine import (DECODE_SPAN, PREFILL_SPAN,  # noqa: F401  (re-export)
                                        ServingEngine, WallClock, sync)
from repro_torch.runtime.engine_config import EngineConfig
from repro_torch.runtime.graph_step import build_decode_step
from repro_torch.runtime.kv_cache import KVCachePool
from repro_torch.runtime.metrics import LatencyStats, pool_summary, serve_summary
from repro_torch.runtime.train_loop import data_split_dims, gather_over_data


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. With no card and no explicit device this raises — nothing
    falls back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def serve_ctx(plan: Optional[PlanConfig], mesh_cfg, groups: Optional[Tuple] = None,
              device="cuda", model=None) -> Optional[ShardCtx]:
    """The serving :class:`~repro_torch.models.common.ShardCtx` of this rank
    under ``plan`` on ``mesh_cfg`` (a ``MeshConfig`` over the initialised
    process group, or a ``launch.mesh.TracedMesh``), or None where the plan
    puts no work on a model axis (neither weights nor the prompt's
    sequence: each rank then serves its rows as one device does). ``groups``: this rank's ``(data group, model group)``,
    else :func:`~repro_torch.launch.mesh.mesh_groups` makes them. The cache
    group is the model group where ``plan.cache_seq_axes`` is
    ``("model",)``, else the group over those axes. Under serve-time FSDP
    (``params_over_data``) the ``ctx.gather`` of ``model``'s parameters
    all-gathers each layer's blocks over the data axes when the layer
    runs."""
    if plan is None or mesh_cfg is None:
        return None
    traced = mesh_cfg if isinstance(mesh_cfg, TracedMesh) else None
    cfg = traced.cfg if traced is not None else mesh_cfg
    if cfg.model_parallelism == 1 or not (plan.tensor_parallel or plan.expert_parallel
                                          or "model" in plan.seq_axes):
        return None
    _data, model_group = groups if groups is not None else mesh_groups(mesh_cfg, device)
    cache_group = None
    if plan.cache_seq_axes:
        if tuple(plan.cache_seq_axes) == ("model",):
            cache_group = model_group
        elif traced is not None:
            cache_group = traced.group(plan.cache_seq_axes)
        else:
            cache_group = axes_group(cfg, plan.cache_seq_axes)
    gather = None
    if plan.params_over_data:
        gather = functools.partial(gather_over_data, data_split_dims(model, plan, cfg), _data)
    return ShardCtx(plan, model_group, gather=gather, cache_group=cache_group, mesh=cfg)


def make_decode_step(model, page: int = 0, seq_len: int = 0,
                     decode_kernel: str = "paged", *, plan: Optional[PlanConfig] = None,
                     mesh_cfg=None, groups: Optional[Tuple] = None, device="cuda"):
    """``page > 0``: the paged decode step, taking the (B, max_pages) page
    table as a fifth argument (None for an arena with no paged entries,
    which then decodes with dense semantics); ``seq_len`` is the bucket
    context the arena is sized for. ``decode_kernel`` picks the paged read
    (paged | gather | ref). With ``plan`` and ``mesh_cfg`` (and this rank's
    ``groups``), the step of this rank under the plan's layout
    (:func:`serve_ctx`): its blocks of the parameters and the cache (a
    tick's one position is never split: context parallelism is the prompt
    pass's)."""
    if plan is not None:
        plan = plan.replace(seq_axes=())
    ctx = serve_ctx(plan, mesh_cfg, groups, device, model)
    if page:
        def decode_step(params, cache, tokens, pos, tables=None):
            return model.decode_step(params, cache, tokens, pos, ctx, tables=tables,
                                     page=page, seq_len=seq_len,
                                     decode_kernel=decode_kernel)
    else:
        def decode_step(params, cache, tokens, pos):
            return model.decode_step(params, cache, tokens, pos, ctx)
    return decode_step


def make_prefill(model, *, plan: Optional[PlanConfig] = None, mesh_cfg=None,
                 groups: Optional[Tuple] = None, device="cuda"):
    """The prompt pass of a batch: ``tokens`` and ``lengths``, every other
    key handed on as the model's ``extra``, as the reference's is. The
    server's prompt pass gives only the first two, so an encoder-decoder
    model, whose ``apply`` reads ``frames``, raises ``KeyError`` there, as
    the reference's does: it serves with ``prefill=False``. With ``plan``
    and ``mesh_cfg``, this rank's prompt pass under the plan's layout
    (:func:`serve_ctx`): the batch is this rank's block of it (its rows,
    and under context-parallel prefill its block of the prompt, with the
    whole prompt's ``lengths``)."""
    ctx = serve_ctx(plan, mesh_cfg, groups, device, model)

    def prefill(params, batch):
        extra = {k: v for k, v in batch.items() if k not in ("tokens", "lengths")}
        return model.prefill(params, batch["tokens"], extra, lengths=batch.get("lengths"),
                             ctx=ctx)
    return prefill


def cache_shardings(model, batch: int, seq_len: int, plan: PlanConfig,
                    mesh_cfg, device_mesh=None):
    """``(specs, parts, shards)`` of the decode cache under ``plan``: meta
    tensors, each entry's spec (``core/sharding.py``, kind "cache") and, on a
    ``device_mesh``, its :class:`~repro_torch.core.sharding.NamedSharding`
    (None without one). ``mesh_cfg`` may be a traced mesh. Each rank's
    block of an entry is :func:`~repro_torch.core.sharding.block_shape` of
    its spec, the shape ``Model.init_cache`` makes under :func:`serve_ctx`
    (the dry run's decode cache)."""
    mesh_cfg = mesh_cfg.cfg if isinstance(mesh_cfg, TracedMesh) else mesh_cfg
    specs, axes = model.cache_specs(batch, seq_len)
    parts = tree_specs(specs, axes, plan, mesh_cfg, "cache")
    shards = None if device_mesh is None else tree_shardings(device_mesh, parts)
    return specs, parts, shards


def plan_step(model, plan: ExecutionPlan, page: int):
    """The eager step of a plan: the prompt pass of a prefill plan; for a
    decode plan the paged decode step at the plan's bucket with its
    decode-attention operator (``none``, an attention-free family's, reads
    as gather)."""
    if plan.shape.kind == "prefill":
        return make_prefill(model)
    kernel = plan.config.decode_kernel
    return make_decode_step(model, page=page, seq_len=plan.shape.seq_len,
                            decode_kernel=kernel if kernel in ("paged", "ref") else "gather")


def greedy_decode(model, params, cache, first_token, start_pos, num_tokens,
                  decode_step=None, tables=None):
    """Greedy generation loop. ``start_pos`` is a scalar or a (B,) per-row
    position vector; ``tables`` is the page table of a paged decode step
    (rows must be page-admitted for their whole span)."""
    step = decode_step or (lambda p, c, t, q: model.decode_step(p, c, t, q))
    toks = first_token
    out = []
    pos = torch.as_tensor(start_pos, dtype=torch.int32, device=first_token.device)
    for _ in range(num_tokens):
        if tables is not None:
            logits, cache = step(params, cache, toks, pos, tables)
        else:
            logits, cache = step(params, cache, toks, pos)
        toks = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(toks)
        pos = pos + 1
    if not out:
        return torch.zeros((first_token.shape[0], 0), dtype=torch.int32,
                           device=first_token.device), cache
    return torch.cat(out, dim=1), cache


_NEXT_RID = itertools.count()


@dataclass(frozen=True)
class ServeRequest:
    """One decode request: ``batch`` sequences with ``context`` prompt
    slots, generating up to ``new_tokens`` tokens greedily. ``eos_id`` stops
    a row at its first end-of-sequence token, ``stop`` is a tuple of token
    sequences any of which stops a row when its output ends with it; the
    request finishes when every row has stopped. ``rid`` is stamped at
    construction from a process-wide counter."""

    batch: int
    context: int
    new_tokens: int = 8
    eos_id: Optional[int] = None
    stop: Tuple[Tuple[int, ...], ...] = ()
    rid: int = field(default_factory=lambda: next(_NEXT_RID))


class PlanServer:
    """Serving session that amortizes plan compilation across requests.

    Request flow (the reference's SystemML recompilation loop):

    1. the request shape rounds up to its power-of-two bucket
       (:class:`BucketPolicy`) and forms a :class:`PlanKey`;
    2. cache hit → reuse the bucket's compiled plan and step; miss → one
       planner walk and one step build, installed in the LRU cache (on the
       card the step captures its CUDA graph at its first tick on an arena,
       and that capture time is billed to ``metrics.compile_seconds``);
    3. after execution, observed :class:`RuntimeStats` (live-bytes
       watermark, actual shape) are checked against the plan's compile-time
       estimates; a breach beyond ``recompile_margin`` re-enters the
       compiler with runtime-corrected statistics and installs the new
       plan — at most once per divergence.

    With ``enable_cache=False`` every request pays the full compile path
    (and, on the card, a fresh capture).

    ``device`` defaults to ``cuda`` and raises when there is no card; the
    tests pass ``device="cpu"``. ``hw`` sizes the planner's statistics
    (default: the H100). Parameters come from ``SpecBuilder.init`` with a
    ``torch.Generator`` seeded from ``config.seed``; callers may replace
    ``server.params`` (for example with weights converted from the reference
    by ``repro_torch.interop``), which drops every captured graph."""

    def __init__(self, cfg: ModelConfig, mesh_cfg: Optional[MeshConfig] = None, *,
                 hw: HardwareSpec = H100, config: Optional[EngineConfig] = None,
                 device=None, policy: BucketPolicy = BucketPolicy()):
        self.config = config if config is not None else EngineConfig()
        c = self.config
        self.cfg = cfg
        self.mesh_cfg = mesh_cfg or SINGLE_DEVICE_MESH
        self.device = resolve_device(device)
        self.dtype = c.torch_dtype()
        self.dtype_name = c.dtype
        self.model = build_model(cfg, dtype=self.dtype)
        # every decode step built, so graphs can be dropped with their
        # arena or their weights
        self._decode_steps = weakref.WeakSet()
        gen = torch.Generator(device=self.device).manual_seed(c.seed)
        self.params = self.model.init_params(gen)
        # block-granular paged arenas (0 = row-granular)
        self.page_size = max(0, c.page_size)
        # compile-time cache statistics are sized for a pool provisioned
        # with ``pool_arenas`` concurrent bucket arenas; the pool's live
        # bytes are checked against them at observe() time
        self.pool_arenas = max(1, c.pool_arenas)
        self.compiler = PlanCompiler(hw, cache_pool_arenas=self.pool_arenas,
                                     cache_page_size=self.page_size,
                                     decode_kernel=c.decode_kernel,
                                     donate_cache=True)
        self.pool = KVCachePool(self.model, self.device, max_arenas=c.pool_max_arenas,
                                max_bytes=c.pool_max_bytes, page_size=self.page_size)
        # drops an evicted arena's graphs (closes over the steps, not the
        # server, so the server is freed as soon as its last reference goes)
        steps = self._decode_steps
        self.pool.on_evict.append(lambda arena: [st.drop(arena) for st in list(steps)])
        self.cache = PlanCache(capacity=c.cache_capacity)
        self.metrics = self.cache.metrics
        self.latency = LatencyStats()
        self.enable_cache = c.enable_cache
        self.recompile_margin = c.recompile_margin
        self.policy = policy
        self.prefill = c.prefill
        self._engine: Optional[ServingEngine] = None

    # ------------------------------------------------------------------
    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self._params

    @params.setter
    def params(self, params: Dict[str, torch.Tensor]) -> None:
        """New weights: every graph captured with the old ones goes."""
        self._params = params
        self._params_bytes = sum(t.nbytes for t in params.values())
        for step in list(self._decode_steps):
            step.clear()

    def decode_graphs(self) -> int:
        """Decode graphs captured and held by this server's entries (0 on the
        CPU)."""
        return sum(step.graphs for step in list(self._decode_steps))

    # ------------------------------------------------------------------
    def _build_step(self, plan: ExecutionPlan):
        """The entry's step: the eager prompt pass for a prefill plan; for a
        decode plan the tick of ``runtime.graph_step`` (a CUDA graph per
        arena on the card), with the plan's decode-attention operator."""
        if plan.shape.kind == "prefill":
            return plan_step(self.model, plan, self.page_size)
        step = build_decode_step(plan_step(self.model, plan, self.page_size), self.device)
        self._decode_steps.add(step)
        return step

    def _compile_entry(self, key: PlanKey) -> CacheEntry:
        t0 = time.perf_counter()
        plan = self.compiler.compile(self.cfg, key.bucket_shape(), self.mesh_cfg,
                                     dtype=self.dtype_name)
        entry = CacheEntry(key=key, plan=plan, step_fn=self._build_step(plan))
        self.metrics.compile_seconds += time.perf_counter() - t0
        return entry

    def _key_for(self, batch: int, context: int, kind: str) -> PlanKey:
        shape = InputShape(f"req_{batch}x{context}", context, batch, kind)
        return PlanKey.for_request(self.cfg, self.mesh_cfg, self.dtype_name, shape,
                                   self.policy)

    def _entry_for(self, key: PlanKey) -> CacheEntry:
        if self.enable_cache:
            return self.cache.get_or_compile(key, lambda: self._compile_entry(key))
        # pre-cache behaviour: full planner walk + a fresh step
        self.metrics.misses += 1
        self.metrics.compiles += 1
        return self._compile_entry(key)

    def decode_entry(self, batch: int, context: int) -> CacheEntry:
        """Bucketed decode plan + its decode step (cache-backed)."""
        return self._entry_for(self._key_for(batch, context, "decode"))

    def prefill_entry(self, batch: int, context: int) -> CacheEntry:
        """Bucketed prefill plan + its prompt pass from the same cache
        (``PlanKey.kind`` keeps the key spaces disjoint)."""
        return self._entry_for(self._key_for(batch, context, "prefill"))

    def run_prefill(self, entry: CacheEntry, tokens=None, lengths=None):
        """Execute a cached prefill plan at its bucket shape; returns
        ``(logits, cache)``: per-row last-prompt-position logits
        ``(batch_bucket, vocab)`` plus the populated decode cache.
        ``tokens`` defaults to all ones and ``lengths`` (the per-row prompt
        length inside the padded bucket) to the full bucket width. Waits
        for the device."""
        b, s = entry.key.batch_bucket, entry.key.seq_bucket
        if tokens is None:
            tokens = torch.ones((b, s), dtype=torch.int32, device=self.device)
        if lengths is None:
            lengths = torch.full((b,), s, dtype=torch.int32, device=self.device)
        logits, kv = entry.step_fn(self.params, {"tokens": tokens, "lengths": lengths})
        sync(self.device)
        return logits, kv

    def prefill_first_token(self, batch: int, context: int,
                            lengths=None) -> Tuple[torch.Tensor, Any]:
        """Prompt pass through the cached prefill plan; returns the greedy
        first decode token per bucket row ``(batch_bucket, 1)`` and the
        populated decode cache for the handoff."""
        entry = self.prefill_entry(batch, context)
        logits, kv = self.run_prefill(entry, lengths=lengths)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], kv

    # ------------------------------------------------------------------
    def observed_stats(self, entry: CacheEntry, shape: InputShape, toks,
                       double_buffer_bytes: float = 0.0) -> RuntimeStats:
        """Measured runtime statistics for one executed request: the live-
        bytes watermark per device (params + the *whole* KV-cache pool +
        in-flight tokens) and the pool's own per-device bytes. Each tensor
        class only divides across the devices the plan shards it over.
        ``double_buffer_bytes``: extra cache-class bytes observed live during
        a tick (0 here: the port's step updates the cache in place)."""
        cfgp = entry.plan.config
        mesh = self.mesh_cfg
        param_div = 1
        if cfgp.tensor_parallel or cfgp.expert_parallel:
            param_div *= mesh.model_parallelism
        if cfgp.params_over_data:
            param_div *= mesh.data_parallelism
        kv_div = 1
        for ax, sz in zip(mesh.axis_names, mesh.shape):
            if ax in cfgp.cache_batch_axes or ax in cfgp.cache_seq_axes:
                kv_div *= sz
        if cfgp.cache_heads_over_model:
            kv_div *= mesh.model_parallelism
        pool_bytes = self.pool.live_bytes()
        watermark = (self._params_bytes / param_div
                     + (pool_bytes + double_buffer_bytes + toks.nbytes) / kv_div)
        return RuntimeStats(shape=shape, watermark_bytes=watermark,
                            cache_pool_bytes=pool_bytes / kv_div)

    def observe(self, key: PlanKey, stats: RuntimeStats
                ) -> Tuple[Optional[CacheEntry], Tuple[str, ...]]:
        """Feed observed runtime statistics back into the cache (dynamic
        recompilation). Compile time is billed only when ``refresh``
        actually re-entered the compiler."""
        if not self.enable_cache:
            return None, ()
        t_r = time.perf_counter()
        recompiles_before = self.metrics.recompiles
        refreshed, reasons = self.cache.refresh(
            key, stats, self.compiler, margin=self.recompile_margin,
            build_step=self._build_step, policy=self.policy)
        if self.metrics.recompiles > recompiles_before:
            self.metrics.compile_seconds += time.perf_counter() - t_r
        return refreshed, reasons

    def buckets(self, batch: int, span: int) -> Tuple[int, int]:
        """(batch bucket, seq bucket) a request shape rounds up to."""
        return (bucket_pow2(batch, self.policy.min_batch),
                bucket_pow2(span, self.policy.min_seq))

    def request_span(self, req: ServeRequest) -> int:
        """Context slots a request needs end to end: prompt plus every
        generated token (bucketing on it keeps a context that sits on a
        power-of-two boundary from overflowing its rows mid-decode)."""
        return req.context + req.new_tokens

    # ------------------------------------------------------------------
    def handle(self, req: ServeRequest) -> Dict[str, Any]:
        """Serve one request synchronously; returns tokens + accounting.

        A submit-and-drain adapter over the server's own
        :class:`~repro_torch.runtime.engine.ServingEngine`: the request's
        group forms (its prompt pass inside ``PREFILL_SPAN``), then the
        engine ticks until it is idle (inside ``DECODE_SPAN``). With
        ``prefill=True`` the prompt pass populates the request's rows and its
        greedy token opens the output; decode step 0 consumes it at the
        prompt's position. Without it the request decodes from a zero cache
        (the decode-only request shape) and emits ``new_tokens`` decode
        outputs. Stop conditions (``eos_id`` / ``stop``) apply. The returned
        keys are the reference's plus the phase timings (``prefill_s``,
        ``decode_s``: host clock, each ending after the device has finished
        the phase), ``decode_steps`` and ``last_logits`` (the request rows'
        logits of the pass that produced its last token)."""
        if self._engine is None:
            # count_first: with a handoff the prefill token is output token
            # #1. sync_per_tick=False: nobody streams this request, so the
            # ticks queue on the device and one wait at the end settles them.
            # The engine sees the server through a weak proxy: the server owns
            # it, and a cycle would keep a dropped server's weights, arenas
            # and graphs on the card until the garbage collector runs
            self._engine = ServingEngine(
                weakref.proxy(self), config=dc_replace(self.config, join_mid_decode=False),
                clock=WallClock(), prefill=self.prefill,
                count_first=self.prefill and self.model.supports_handoff,
                eager_pages=True, sync_per_tick=False)
        eng = self._engine
        t0 = time.perf_counter()
        handle = eng.submit(req)
        eng.admit()
        t1 = time.perf_counter()
        steps = 0
        with torch.profiler.record_function(DECODE_SPAN):
            while not eng.idle:
                # a step ticks the request's group while the request is live,
                # and retires the group once it has finished
                steps += handle.result is None
                eng.step()
            sync(self.device)
        t2 = time.perf_counter()
        rec = handle.result
        eng.discard(handle)   # one-shot: don't accumulate engine records
        # latency includes any in-request recompilation — that cost is the
        # mechanism under measurement, not overhead to hide
        latency = t2 - t0
        self.latency.record(latency)
        return {
            "tokens": rec["tokens"],
            "latency_s": latency,
            "bucket": rec["bucket"],
            "plan": rec["plan"],
            "recompiled": rec["recompiled"],
            "recompile_reasons": rec["recompile_reasons"],
            "watermark_bytes": rec["watermark_bytes"],
            "pool_bytes": rec["pool_bytes"],
            "finish_reason": rec["finish_reason"],
            "rid": req.rid,
            "prefill_s": t1 - t0 if self.prefill else 0.0,
            "decode_s": t2 - t1,
            "decode_steps": steps,
            "last_logits": rec["last_logits"],
        }

    def summary(self) -> str:
        return serve_summary(self.metrics, self.latency) + "\n" + pool_summary(self.pool)
