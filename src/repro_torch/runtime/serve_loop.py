"""Serving runtime: prefill + paged decode (port of
``repro/runtime/serve_loop.py``).

:class:`PlanServer` is the sequential front door. Its :meth:`PlanServer.handle`
runs one request the way the reference's ``ServingEngine`` runs it for
``PlanServer.handle`` (no mid-decode joins, whole-span pages committed at
admission):

1. round the request up to its (batch, span) power-of-two bucket;
2. acquire an arena of that bucket from the KV-cache pool;
3. admit the request's rows (pages for the whole span);
4. prefill the prompt (with ``prefill=True``);
5. scatter the prefill's cache into the rows (the handoff write: K/V through
   the page tables, recurrent state and conv tails row by row);
6. decode greedily on the paged tables, one step per token (a
   pure-recurrent arena has no page table and decodes its rows directly).

The plan compiler, plan cache, dynamic recompilation, the engine with its
scheduler and metrics come in slice 2; until then each bucket's step is the
eager model call.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.plan_cache import BucketPolicy, bucket_pow2
from repro_torch.models.model import build_model
from repro_torch.runtime.engine_config import EngineConfig
from repro_torch.runtime.kv_cache import KVCachePool

# names of PlanServer.handle's phases as torch.profiler spans
PREFILL_SPAN = "PlanServer.prefill"
DECODE_SPAN = "PlanServer.decode"


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_decode_step(model, page: int = 0, seq_len: int = 0,
                     decode_kernel: str = "paged"):
    """``page > 0``: the paged decode step, taking the (B, max_pages) page
    table as a fifth argument (None for an arena with no paged entries,
    which then decodes with dense semantics); ``seq_len`` is the bucket
    context the arena is sized for. ``decode_kernel`` picks the paged read
    (paged | gather | ref)."""
    if page:
        def decode_step(params, cache, tokens, pos, tables=None):
            return model.decode_step(params, cache, tokens, pos, tables=tables,
                                     page=page, seq_len=seq_len,
                                     decode_kernel=decode_kernel)
    else:
        def decode_step(params, cache, tokens, pos):
            return model.decode_step(params, cache, tokens, pos)
    return decode_step


def make_prefill(model):
    def prefill(params, batch):
        return model.prefill(params, batch["tokens"], lengths=batch.get("lengths"))
    return prefill


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


class _StopState:
    """Per-request stop-condition tracking (the reference engine's
    ``_register_token`` checks)."""

    def __init__(self, req: ServeRequest):
        self.req = req
        self.rows_live = np.ones(req.batch, bool)
        self.tails: List[List[int]] = [[] for _ in range(req.batch)]

    def check(self, tok: torch.Tensor) -> Optional[str]:
        req = self.req
        if req.eos_id is None and not req.stop:
            return None
        tok_host = tok[:, 0].cpu().numpy()
        if req.eos_id is not None:
            self.rows_live &= tok_host != req.eos_id
            if not self.rows_live.any():
                return "eos"
        if req.stop:
            max_len = max(len(s) for s in req.stop)
            for i in range(req.batch):
                if not self.rows_live[i]:
                    continue
                tail = self.tails[i]
                tail.append(int(tok_host[i]))
                del tail[:-max_len]
                if any(len(s) <= len(tail) and tail[len(tail) - len(s):] == list(s)
                       for s in req.stop):
                    self.rows_live[i] = False
            if not self.rows_live.any():
                return "stop"
        return None


class PlanServer:
    """Sequential serving session over a paged KV-cache pool.

    ``device`` defaults to ``cuda`` and raises when there is no card; the
    tests pass ``device="cpu"``. Parameters come from ``SpecBuilder.init``
    with a ``torch.Generator`` seeded from ``config.seed``; callers may
    replace ``server.params`` (for example with weights converted from the
    reference by ``repro_torch.interop``)."""

    def __init__(self, cfg: ModelConfig, *, config: Optional[EngineConfig] = None,
                 device=None, policy: BucketPolicy = BucketPolicy()):
        self.config = config if config is not None else EngineConfig()
        c = self.config
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = c.torch_dtype()
        self.model = build_model(cfg, dtype=self.dtype)
        gen = torch.Generator(device=self.device).manual_seed(c.seed)
        self.params = self.model.init_params(gen)
        self.page_size = c.page_size
        self.pool_arenas = c.pool_arenas
        self.pool = KVCachePool(self.model, self.device,
                                max_arenas=c.pool_max_arenas,
                                max_bytes=c.pool_max_bytes, page_size=self.page_size)
        self.policy = policy
        self.prefill = c.prefill
        self.decode_kernel = c.decode_kernel
        self.latencies: List[float] = []

    def buckets(self, batch: int, span: int) -> Tuple[int, int]:
        """(batch bucket, seq bucket) a request shape rounds up to."""
        return (bucket_pow2(batch, self.policy.min_batch),
                bucket_pow2(span, self.policy.min_seq))

    def request_span(self, req: ServeRequest) -> int:
        """Context slots a request needs end to end: prompt plus every
        generated token (bucketing on it keeps a context that sits on a
        power-of-two boundary from overflowing its rows mid-decode)."""
        return req.context + req.new_tokens

    def run_prefill(self, batch_bucket: int, seq_bucket: int, tokens=None,
                    lengths=None):
        """Prompt pass at a bucket shape; returns ``(logits, cache)``:
        per-row last-prompt-position logits ``(batch_bucket, vocab)`` plus
        the populated decode cache. ``tokens`` defaults to all ones and
        ``lengths`` to the full bucket width. Waits for the device."""
        b, s = batch_bucket, seq_bucket
        if tokens is None:
            tokens = torch.ones((b, s), dtype=torch.int32, device=self.device)
        if lengths is None:
            lengths = torch.full((b,), s, dtype=torch.int32, device=self.device)
        logits, kv = make_prefill(self.model)(
            self.params, {"tokens": tokens, "lengths": lengths})
        _sync(self.device)
        return logits, kv

    def handle(self, req: ServeRequest) -> Dict[str, Any]:
        """Serve one request synchronously; returns tokens + accounting.

        With ``prefill=True`` the prompt pass populates the request's rows
        and its greedy token opens the output; decode step 0 consumes it at
        the prompt's position. Without it the request decodes from a zero
        cache (the decode-only request shape) and emits ``new_tokens``
        decode outputs."""
        t0 = time.perf_counter()
        dev = self.device
        span = self.request_span(req)
        b, s = self.buckets(req.batch, span)
        demand = (self.pool.member_bytes(s, req.batch, span)
                  if self.pool.paged else None)
        arena = self.pool.acquire(b, s, zero=not self.prefill, force=True,
                                  demand_bytes=demand)
        rows = self.pool.admit_request_rows(
            arena, req.batch, prompt=req.context if self.prefill else 0,
            span=span, eager=True)
        rows_t = torch.tensor(rows, dtype=torch.long, device=dev)
        toks = torch.ones((b, 1), dtype=torch.int32, device=dev)
        pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        stops = _StopState(req)
        out: List[torch.Tensor] = []
        reason = None
        logits = None
        t_prefill = 0.0
        # the two spans name the phases in a torch.profiler trace; each ends
        # after the device has finished the phase's work
        if self.prefill:
            with torch.profiler.record_function(PREFILL_SPAN):
                lengths = torch.tensor([req.context] * req.batch
                                       + [1] * (b - req.batch),
                                       dtype=torch.int32, device=dev)
                logits, pkv = self.run_prefill(b, s, lengths=lengths)
                first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                self.pool.write_rows(arena, rows, pkv, src_rows=range(len(rows)))
                del pkv
                pos[rows_t] = req.context
                toks[rows_t] = first[:len(rows)]
                _sync(dev)
            t_prefill = time.perf_counter() - t0
            out.append(first[:req.batch])
            reason = stops.check(out[-1])

        base_pos = req.context if self.prefill else 0
        step = make_decode_step(self.model, page=self.page_size, seq_len=s,
                                decode_kernel=self.decode_kernel)
        t1 = time.perf_counter()
        steps = 0
        with torch.profiler.record_function(DECODE_SPAN):
            while reason is None and len(out) < req.new_tokens:
                if self.pool.paged:
                    self.pool.ensure_decode_slots(arena, rows, base_pos + steps)
                    logits, _ = step(self.params, arena.cache, toks, pos, arena.tables)
                else:
                    logits, _ = step(self.params, arena.cache, toks, pos)
                toks = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
                pos = pos + 1
                steps += 1
                out.append(toks[rows_t])
                reason = stops.check(out[-1])
            tokens = (torch.cat(out, dim=1) if out
                      else torch.zeros((req.batch, 0), dtype=torch.int32, device=dev))
            _sync(dev)
        t_end = time.perf_counter()
        self.pool.free_rows(arena, rows, early=reason is not None)
        self.pool.release(arena)
        self.latencies.append(t_end - t0)
        last = None
        if logits is not None:
            last = logits[:, -1] if logits.dim() == 3 else logits
            last = last[rows_t]
        return {
            "tokens": tokens,
            "latency_s": t_end - t0,
            "prefill_s": t_prefill,
            "decode_s": t_end - t1,
            "decode_steps": steps,
            "bucket": (b, s),
            "finish_reason": reason or "length",
            "last_logits": last,
            "rid": req.rid,
        }

    def summary(self) -> str:
        m = self.pool.metrics
        lat = sorted(self.latencies)
        p50 = lat[len(lat) // 2] * 1e3 if lat else 0.0
        return (f"served {len(lat)} requests | latency p50={p50:.1f}ms "
                f"max={(lat[-1] * 1e3 if lat else 0.0):.1f}ms | kv_pages "
                f"leased={m.pages_leased} freed={m.pages_freed} "
                f"peak={m.peak_pages} | arenas created={m.arenas_created} "
                f"reused={m.arenas_reused} | rows leased={m.rows_leased} "
                f"handoff_writes={m.handoff_writes}")
