"""Model assembly for every family (port of ``repro/models/model.py``).

Parameters are a flat dict with the reference's keys and layer-stacked
layouts (``l.wq`` is ``(L, d, Hq, Dh)``; the hybrid family stacks its RG-LRU
layers under ``r.`` and its attention layers under ``a.``; the audio
family's encoder under ``e.`` and its decoder, whose blocks add cross
attention, under ``d.``), so weights convert one to one
(``repro_torch.interop``). The reference's ``lax.scan`` over layers, and its
unrolled hybrid pattern, become one Python loop over the layers in order
(:meth:`Model.layers`). The MoE family is the dense stack with the MoE FFN
(``blocks.moe_ffn``); its layers' load-balance losses are averaged into the
auxiliary loss, as the reference's scan does.

The modality frontends are stubs, as in the reference: the vision family
(InternVL2) takes precomputed ``patch_embeds`` and puts them before the
text; the audio family (Whisper) takes precomputed ``frames``, runs them
through its bidirectional encoder (ending in an RMS norm with the
decoder's ``final_ln``, as the reference does) and reads the encoder's
output through every decoder layer's cross attention. In decode the
decoder's self-attention K/V are paged like any attention cache and each
layer's cross K/V (``x.k``/``x.v``, :meth:`Model.build_cross_cache`) stay
per row. Neither family hands a prompt pass's cache to decode
(:attr:`Model.supports_handoff`).

Training: :meth:`Model.loss` is the reference's loss over the full-sequence
forward, with the reference's per-layer rematerialisation when the plan asks
for it (``remat``: each layer under ``torch.utils.checkpoint``, its
activations recomputed in the backward pass). A layer stack may be given as
a list of per-layer tensors instead of one stacked tensor: the train step
(``runtime/train_loop.py``) passes per-layer leaves, so each layer's
gradient lands in a tensor of its own. Over ranks the step also hands it a
:class:`~repro_torch.models.common.ShardCtx`: under FSDP its ``gather``
turns each rank's parameter shards into the tensors the model axis leaves
when they are used (:meth:`Model.apply`), its ``ranks_mean`` makes the MoE
load-balance statistics means over the data ranks, and over a model axis
the blocks run on the rank's parameter blocks: the embedding a masked
lookup into the rank's vocab block, the residual stream whole on every
model rank (or, under sequence parallelism, its sequence shard: each
remat checkpoint is the shard), the logits the rank's vocab block and the
loss the vocab-parallel cross-entropy. :meth:`Model.param_specs`,
:meth:`Model.param_axes` and :meth:`Model.cache_specs` give the sharding
rules (``core/sharding.py``) each tensor's shape and logical axes.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.core import comm
from repro_torch.core.sharding import block_shape, spec_for
from repro_torch.models import blocks as B
from repro_torch.models.common import (ShardCtx, SpecBuilder, rms_norm, softmax_xent_logits,
                                       softmax_xent_vocab)

_PORTED = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# weight of the MoE auxiliary loss in the total (the reference's)
MOE_AUX_COEF = 0.01
def _subtree(params: Dict, prefix: str) -> Dict:
    plen = len(prefix)
    return {k[plen:]: v for k, v in params.items() if k.startswith(prefix)}


class Model:
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16):
        if cfg.family not in _PORTED:
            raise NotImplementedError(
                f"{cfg.name}: no family {cfg.family!r}; the port builds the "
                f"{', '.join(_PORTED[:-1])} and {_PORTED[-1]} families")
        self.cfg = cfg
        self.dtype = dtype
        self.sb = self._build_specs()

    # ------------------------------------------------------------------
    # parameter specs
    # ------------------------------------------------------------------
    def _build_specs(self) -> SpecBuilder:
        cfg = self.cfg
        sb = SpecBuilder(self.dtype)
        sb.add("embed", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
               "normal", scale=0.02)
        for prefix, n, blocks in self._stacks():
            for name, (shape, axes, init) in blocks.items():
                sb.add(f"{prefix}{name}", (n, *shape), ("layers", *axes), init)
        sb.add("final_ln", (cfg.d_model,), (None,), "ones")
        if not cfg.tie_embeddings:
            sb.add("head", (cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                   "normal", scale=0.02)
        return sb

    def _stacks(self):
        """(prefix, layers, per-layer param specs) of each layer stack. A
        hybrid pattern that drops a block kind keeps its zero-layer stack,
        as the reference does."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            pat = cfg.layer_pattern()
            return (("r.", pat.count("r"), B.rglru_block_params(cfg)),
                    ("a.", pat.count("a"), B.attn_block_params(cfg)))
        if cfg.is_encdec:
            return (("e.", cfg.encoder_layers, B.attn_block_params(cfg)),
                    ("d.", cfg.num_layers, B.attn_block_params(cfg, cross=True)))
        blocks = B.ssd_block_params(cfg) if self.is_ssm else B.attn_block_params(cfg)
        return (("l.", cfg.num_layers, blocks),)

    def layers(self, encoder: bool = False) -> Iterator[Tuple[str, str, int]]:
        """(kind, stack prefix, index in the stack) of every layer in order;
        kind is 'a' attention, 'r' RG-LRU or 's' SSD. The layers of the
        decoder (the only stack but for an encoder-decoder), or with
        ``encoder`` those of the encoder."""
        cfg = self.cfg
        if encoder:
            yield from (("a", "e.", i) for i in range(cfg.encoder_layers))
            return
        seen: Dict[str, int] = {}
        for kind in cfg.layer_pattern():
            prefix = (f"{kind}." if cfg.family == "hybrid"
                      else "d." if cfg.is_encdec else "l.")
            yield kind, prefix, seen.setdefault(prefix, 0)
            seen[prefix] += 1

    @property
    def is_ssm(self) -> bool:
        return self.cfg.family == "ssm"

    def param_specs(self) -> Dict[str, torch.Tensor]:
        """Each parameter's shape and dtype, as a tensor on the meta device."""
        return {k: torch.empty(sh, dtype=dt, device="meta")
                for k, (sh, dt) in self.sb.shapes().items()}

    def param_axes(self) -> Dict[str, Tuple]:
        """Each parameter's logical axes (``core/sharding.py``)."""
        return {k: ax for k, (_sh, ax, _ini, _sc, _dt) in self.sb.entries.items()}

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        return self.sb.init(generator)

    def param_count(self) -> int:
        return sum(math.prod(sh) for sh, _dt in self.sb.shapes().values())

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------
    def _embed(self, params, tokens):
        x = params["embed"][tokens.long()]
        if self.cfg.tie_embeddings:
            x = x * (self.cfg.d_model ** 0.5)
        return x

    def _logits(self, params, x, ctx: Optional[ShardCtx] = None):
        """Logits of ``x``; over a model axis (``ctx.tp``) the rank's vocab
        block of them."""
        if ctx is not None and ctx.tp:
            if self.cfg.tie_embeddings:
                return torch.matmul(x, self._vocab_table(params, ctx).t())
            return torch.matmul(x, ctx.part(params["head"], 1, self.cfg.vocab_size))
        if self.cfg.tie_embeddings:
            return torch.matmul(x, params["embed"].t())
        return torch.matmul(x, params["head"])

    @staticmethod
    def _layer(stacked: Dict, i: int) -> Dict:
        return {k: v[i] for k, v in stacked.items()}

    # ------------------------------------------------------------------
    # full-sequence forward (prefill)
    # ------------------------------------------------------------------
    def apply(self, params, tokens: torch.Tensor,
              extra: Optional[Dict[str, torch.Tensor]] = None, *, last_only: bool = False,
              remat: bool = False, ctx: Optional[ShardCtx] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns ``(logits, aux_loss)``: logits for every text position,
        or with ``last_only`` for the final position only (``(B, 1,
        vocab)``). ``extra`` holds the frontends' inputs: a vision model's
        ``patch_embeds`` ``(B, P, D)`` (cast to the activation dtype and put
        before the text, positions running over both; the logits drop the
        prefix), an encoder-decoder's ``frames`` ``(B, Senc, D)``, which the
        encoder reads (:meth:`_encode`). The auxiliary loss is the mean over
        the layers of the MoE load-balance loss (0 for every other family).
        With ``remat`` each layer's activations, the encoder's too, are
        recomputed in the backward pass. ``ctx`` (a train step over ranks):
        ``ctx.gather`` (FSDP) turns the parameters this rank holds into
        those the model axis leaves, the embedding, final norm and head
        here, each layer's when the layer runs (again in its recompute
        under remat); over a model axis (``ctx.tp``) the logits are this
        rank's vocab block (:meth:`vocab_span`), or with ``last_only`` the
        whole vocab's, gathered over the model group. Under context-parallel
        prefill (``ctx.cp``) ``tokens`` are this rank's block of the
        prompt."""
        cfg = self.cfg
        extra = extra or {}
        params = self._gathered_top(params, ctx)
        tp = ctx is not None and ctx.tp
        if tp and ctx.cp:
            # each rank holds its block of the prompt; the vocab-parallel
            # embedding reads every rank's ids
            tokens = comm.all_gather_dim(tokens, 1, ctx.model_group)
        x = self._embed_tp(params, tokens, ctx) if tp else self._embed(params, tokens)
        prefix = 0
        if cfg.frontend == "vision" and "patch_embeds" in extra:
            pe = extra["patch_embeds"].to(x.dtype)
            if tp:                          # a partial sum: the prefix on one rank
                pe = pe if ctx.mrank == 0 else torch.zeros_like(pe)
            x = torch.cat([pe, x], dim=1)
            prefix = pe.shape[1]
        if tp:
            x = ctx.leave(x)
        enc_out = None
        if cfg.is_encdec:
            enc_out = self._encode(params, extra["frames"].to(x.dtype), remat=remat, ctx=ctx)
        x, _, aux = self._stack_prefill(params, x, want_cache=False, remat=remat, ctx=ctx,
                                        enc_out=enc_out)
        if tp and last_only:
            x = rms_norm(x, ctx.gain(params["final_ln"]))
            last = torch.full((x.shape[0],), ctx.seq_len(x.shape[1]) - 1, device=x.device)
            logits = self._whole_logits(params, ctx.last_rows(x, last)[:, None], ctx)
        elif tp:
            x = ctx.enter(rms_norm(x, ctx.gain(params["final_ln"])))
            logits = self._logits(params, x, ctx)[:, prefix:]
        else:
            x = rms_norm(x, params["final_ln"])
            if last_only:
                # the last position is never inside the vision prefix
                logits = self._logits(params, x[:, -1:])
            else:
                logits = self._logits(params, x)[:, prefix:]
        return logits, torch.zeros((), device=logits.device) if aux is None else aux

    def _whole_logits(self, params, x, ctx: Optional[ShardCtx] = None) -> torch.Tensor:
        """Serving logits of ``x`` over the whole vocab on every rank: over a
        model axis whose rules split the vocab, this rank's block of them
        all-gathered over the model group; else the product with the whole
        table."""
        if ctx is not None and ctx.tp:
            table = params["embed"] if self.cfg.tie_embeddings else params["head"]
            if table.shape[0 if self.cfg.tie_embeddings else 1] != self.cfg.vocab_size:
                return comm.all_gather_dim(self._logits(params, x, ctx), x.dim() - 1,
                                           ctx.model_group)
        return self._logits(params, x)

    @staticmethod
    def _gathered_top(params, ctx: Optional[ShardCtx]):
        """``params`` with the embedding, final norm and head whole over the
        data axes (``ctx.gather``, FSDP); the layers gather when they run."""
        if ctx is None or ctx.gather is None:
            return params
        params = dict(params)
        params.update(ctx.gather("", {k: v for k, v in params.items() if "." not in k}))
        return params

    def vocab_span(self, ctx: ShardCtx) -> Tuple[int, int]:
        """The rank's ``[lo, hi)`` of the vocab over a model axis: the block
        the rules give it where the vocab splits, else its
        :meth:`ShardCtx.span` of the whole table."""
        return ctx.span(self.cfg.vocab_size)

    def _vocab_table(self, params, ctx: ShardCtx) -> torch.Tensor:
        """The rank's rows of the embedding table (its block, or a slice of
        the whole table whose gradient is summed over the model group)."""
        return ctx.part(params["embed"], 0, self.cfg.vocab_size)

    def _embed_tp(self, params, tokens, ctx: ShardCtx) -> torch.Tensor:
        """The embedding over a model axis: a partial sum, each token's row
        on the rank whose vocab block holds it and zeros elsewhere."""
        table = self._vocab_table(params, ctx)
        lo, _hi = self.vocab_span(ctx)
        ids = tokens.long() - lo
        own = (ids >= 0) & (ids < table.shape[0])
        x = table[ids.clamp(0, table.shape[0] - 1)] * own[..., None].to(table.dtype)
        if self.cfg.tie_embeddings:
            x = x * (self.cfg.d_model ** 0.5)
        return x

    def _encode(self, params, frames: torch.Tensor, *, remat: bool = False,
                ctx: Optional[ShardCtx] = None) -> torch.Tensor:
        """The encoder stack over ``frames`` ``(B, Senc, D)``: bidirectional
        attention blocks, then an RMS norm with the decoder's ``final_ln``
        (the reference's, which the encoder shares). Under sequence
        parallelism each rank encodes its shard of the frames' positions."""
        gain = params["final_ln"]
        if ctx is not None and ctx.tp:
            gain = ctx.gain(gain)
            if ctx.sp:
                frames = comm.block_of(frames, 1, ctx.model_group)
        x, _, _ = self._stack_prefill(params, frames, want_cache=False, remat=remat,
                                      ctx=ctx, encoder=True)
        return rms_norm(x, gain)

    def _stack_prefill(self, params, x, *, lengths: Optional[torch.Tensor] = None,
                       want_cache: bool = True, remat: bool = False,
                       ctx: Optional[ShardCtx] = None,
                       enc_out: Optional[torch.Tensor] = None, encoder: bool = False):
        """The layers over a full sequence: ``(x, caches, aux)``: the
        decoder's, every decoder block reading ``enc_out`` through its
        cross attention where it is given, or with ``encoder`` the
        encoder's, bidirectional. With
        ``want_cache`` the caches are the layer-stacked per-layer caches:
        rope'd K/V ``(L, B, S, Kv, Dh)`` for attention, the decode state
        after each row's ``lengths`` prompt tokens for SSD and RG-LRU (else
        None). ``aux`` is the mean of the layers' MoE load-balance losses
        (None without experts). With ``remat`` (no cache) each layer runs
        under ``torch.utils.checkpoint``, as the reference's
        ``jax.checkpoint`` per layer: only its input is kept (under sequence
        parallelism the rank's shard), and the backward pass runs it again,
        its collectives too (a layer holds no randomness, so no RNG state is
        kept)."""
        stacks = {prefix: _subtree(params, prefix) for prefix, _n, _b in self._stacks()}
        seq = x.shape[1] if ctx is None else ctx.seq_len(x.shape[1])
        positions = torch.arange(seq, device=x.device)
        caches: Dict[str, list] = {prefix: [] for prefix in stacks}
        auxs = []
        causal = not encoder
        gather = None if ctx is None else ctx.gather
        for kind, prefix, i in self.layers(encoder):
            lp = self._layer(stacks[prefix], i)
            gather_layer = None if gather is None else functools.partial(gather, prefix)
            if remat and not want_cache:
                x, aux = checkpoint(self._layer_apply, kind, lp, x, positions, lengths,
                                    gather=gather_layer, ctx=ctx, causal=causal,
                                    enc_out=enc_out, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux, *c = self._layer_apply(kind, lp, x, positions, lengths, want_cache,
                                               gather=gather_layer, ctx=ctx, causal=causal,
                                               enc_out=enc_out)
                if want_cache:
                    caches[prefix].append(c[0])
            auxs.append(aux)
        aux = torch.stack(auxs).mean() if self.cfg.num_experts else None
        if not want_cache:
            return x, None, aux
        return x, {f"{prefix}{k}": torch.stack([c[k] for c in cs])
                   for prefix, cs in caches.items() if cs for k in cs[0]}, aux

    def _layer_apply(self, kind: str, lp: Dict, x: torch.Tensor, positions: torch.Tensor,
                     lengths: Optional[torch.Tensor], want_cache: bool = False, *,
                     gather: Optional[Callable[[Dict], Dict]] = None,
                     ctx: Optional[ShardCtx] = None, causal: bool = True,
                     enc_out: Optional[torch.Tensor] = None):
        """One layer over a full sequence: ``(x, aux)``, or ``(x, aux,
        cache)`` with ``want_cache``; ``aux`` is the MoE load-balance loss
        (0.0 without experts). ``gather`` turns the layer's parameters into
        full ones first (inside the checkpointed call, so a recompute
        gathers again). An attention layer is causal (with the arch's
        window) or, for the encoder, bidirectional; ``enc_out`` is the
        encoder's output a decoder block's cross attention reads."""
        if gather is not None:
            lp = gather(lp)
        if kind == "a":
            x, aux, c = B.attn_block_apply(self.cfg, lp, x, positions, causal=causal,
                                           window=self.cfg.window_size if causal else 0,
                                           ctx=ctx, enc_out=enc_out)
            return (x, aux, c) if want_cache else (x, aux)
        block = B.ssd_block_apply if kind == "s" else B.rglru_block_apply
        out = block(self.cfg, lp, x, lengths=lengths, want_cache=want_cache, ctx=ctx)
        return (out[0], 0.0, out[1]) if want_cache else (out, 0.0)

    # ------------------------------------------------------------------
    # loss
    # ------------------------------------------------------------------
    def loss(self, params, batch: Dict[str, torch.Tensor], *, remat: bool = False,
             ctx: Optional[ShardCtx] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's training loss: the float32 mean cross-entropy of
        ``batch["targets"]`` under the logits of ``batch["tokens"]``, plus
        ``MOE_AUX_COEF`` times the auxiliary loss (the MoE family's
        load-balance loss; 0 for the others). Returns ``(total, {"xent",
        "aux"})``. The batch is also :meth:`apply`'s ``extra`` (a vision
        model's ``patch_embeds``, an encoder-decoder's ``frames``). ``ctx``:
        as :meth:`apply`; over a model axis the cross-entropy is the
        vocab-parallel one (``common.softmax_xent_vocab``), the same loss on
        every model rank."""
        logits, aux = self.apply(params, batch["tokens"], batch, remat=remat, ctx=ctx)
        if ctx is not None and ctx.tp:
            xent = softmax_xent_vocab(logits, batch["targets"], self.vocab_span(ctx)[0],
                                      ctx.model_group)
        else:
            xent = softmax_xent_logits(logits, batch["targets"])
        total = xent + MOE_AUX_COEF * aux
        return total, {"xent": xent, "aux": aux}

    @property
    def supports_handoff(self) -> bool:
        """Whether prefill can hand a populated cache to decode: decoder-only
        text stacks do; enc-dec and modality-prefix frontends start decode
        from a zero cache."""
        return not self.cfg.is_encdec and self.cfg.frontend == "none"

    def prefill(self, params, tokens: torch.Tensor,
                extra: Optional[Dict[str, torch.Tensor]] = None, *,
                lengths: Optional[torch.Tensor] = None,
                cache_len: Optional[int] = None, ctx: Optional[ShardCtx] = None):
        """Prompt pass returning ``(last_logits, cache)``: each row's
        next-token logits at its own final prompt position ``(B, vocab)``
        and a populated decode cache — the :meth:`init_cache` dict at
        ``(batch, cache_len)`` — for the prefill→decode handoff.
        ``lengths`` is the per-row prompt length inside the padded
        ``tokens`` (default: the full width). A family without a handoff
        returns the last position's logits of :meth:`apply` over ``tokens``
        and ``extra`` (``lengths`` unread) and no cache, as the reference
        does.

        ``ctx`` (a serving ``ShardCtx`` over a model axis): the blocks run
        on this rank's parameter blocks, the logits are the whole vocab's
        on every rank, and the cache is this rank's block of it under the
        plan's cache layout (:meth:`init_cache` with the same ``ctx``'s
        plan and mesh): its kv heads, or under ``cache_seq_axes`` its
        slots. Under context-parallel prefill ``tokens`` are this rank's
        block of the prompt and ``lengths`` the whole prompt's."""
        if not self.supports_handoff:
            logits, _ = self.apply(params, tokens, extra, last_only=True, ctx=ctx)
            return logits[:, -1], None
        tp = ctx is not None and ctx.tp
        params = self._gathered_top(params, ctx)
        if tp and ctx.cp:
            tokens = comm.all_gather_dim(tokens, 1, ctx.model_group)
        b, s = tokens.shape
        dev = tokens.device
        if lengths is None:
            lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
        lengths = lengths.to(device=dev, dtype=torch.int32)
        cache_len = cache_len or s
        x = ctx.leave(self._embed_tp(params, tokens, ctx)) if tp else self._embed(params, tokens)
        x, cache, _aux = self._stack_prefill(params, x, lengths=lengths, ctx=ctx)
        x = rms_norm(x, params["final_ln"])
        # the reference's take_along_axis clamps; lengths >= 1 on every path
        last = torch.clamp(lengths.long() - 1, 0, s - 1)
        xl = ctx.last_rows(x, last) if tp else x[torch.arange(b, device=dev), last]   # (B, D)
        logits = self._whole_logits(params, xl[:, None], ctx)[:, 0]
        # attention K/V land in their decode-slot layout; recurrent state
        # entries are already in decode form
        sc = self.attn_cache_len(cache_len)
        cache = {k: (gather_cache_slots(v, lengths, sc) if self.is_paged_cache_key(k)
                     else v) for k, v in cache.items()}
        ent = self.cache_entries(b, cache_len, ctx, local_rows=True)
        if tp:
            cache = {k: _rank_block(v, ent[k][0], k, ctx) for k, v in cache.items()}
        # the init_cache dict exactly: a hybrid pattern that drops a block
        # kind still carries that kind's zero-layer entries
        for k, (shape, _axes, dt) in ent.items():
            if k not in cache:
                cache[k] = torch.zeros(shape, dtype=dt, device=dev)
        return logits, cache

    # ------------------------------------------------------------------
    # serving: cache construction + one-token decode
    # ------------------------------------------------------------------
    def attn_cache_len(self, seq_len: int) -> int:
        """Attention cache slots for a ``seq_len`` context: the window for
        sliding-window archs, min(seq, serve_window) beyond the long-context
        threshold, the full context otherwise."""
        cfg = self.cfg
        if cfg.window_size:
            return min(seq_len, cfg.window_size)
        if seq_len > 262_144 and cfg.serve_window:
            return min(seq_len, cfg.serve_window)
        return seq_len

    def decode_window(self, seq_len: int) -> int:
        cfg = self.cfg
        if cfg.window_size:
            return cfg.window_size
        if seq_len > 262_144 and cfg.serve_window:
            return cfg.serve_window
        return 0

    def cache_entries(self, batch: int, seq_len: int, ctx: Optional[ShardCtx] = None,
                      local_rows: bool = False) -> Dict[str, Tuple]:
        """{name: (shape, axes, dtype)} for the decode cache; with a serving
        ``ctx`` (its ``plan`` and ``mesh``) each shape is this rank's block
        under the plan's cache specs (``core/sharding.py``, kind "cache")
        of a ``batch``-row cache, or with ``local_rows`` of a cache whose
        ``batch`` rows are this rank's already."""
        ent = self._cache_entries(batch, seq_len)
        if ctx is None or ctx.mesh is None:
            return ent
        plan = ctx.plan.replace(cache_batch_axes=()) if local_rows else ctx.plan
        return {k: (block_shape(shape, spec_for(shape, axes, plan, ctx.mesh, "cache"),
                                ctx.mesh), axes, dt)
                for k, (shape, axes, dt) in ent.items()}

    def _cache_entries(self, batch: int, seq_len: int) -> Dict[str, Tuple]:
        cfg = self.cfg
        ent = {}
        if self.is_ssm:
            for name, (shape, axes, dt) in B.ssd_cache_spec(cfg, batch, self.dtype).items():
                ent[f"l.{name}"] = ((cfg.num_layers, *shape), ("layers", *axes), dt)
            return ent
        n_attn, prefix = cfg.num_layers, "d." if cfg.is_encdec else "l."
        if cfg.family == "hybrid":
            pat = cfg.layer_pattern()
            n_attn, prefix = pat.count("a"), "a."
            for name, (shape, axes, dt) in B.rglru_cache_spec(cfg, batch,
                                                              self.dtype).items():
                ent[f"r.{name}"] = ((pat.count("r"), *shape), ("layers", *axes), dt)
        sc = self.attn_cache_len(seq_len)
        for name, (shape, axes) in B.attn_cache_spec(cfg, batch, sc).items():
            ent[f"{prefix}{name}"] = ((n_attn, *shape), ("layers", *axes), self.dtype)
        if cfg.is_encdec:
            # each decoder layer's cross K/V over the encoder's output
            kv = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
            axes = ("layers", "batch", None, "kv_heads", "head_dim")
            ent["x.k"] = (kv, axes, self.dtype)
            ent["x.v"] = (kv, axes, self.dtype)
        return ent

    @staticmethod
    def is_paged_cache_key(key: str) -> bool:
        """Attention K/V stacks page their sequence dimension; recurrent
        state is O(1) in sequence and an encoder-decoder's cross K/V fixed
        in it: both stay per row."""
        return (key.endswith(".k") or key.endswith(".v")) and not key.startswith("x.")

    def paged_cache_entries(self, batch: int, seq_len: int, page: int,
                            ctx: Optional[ShardCtx] = None):
        """Block-granular layout: attention K/V trade their per-row sequence
        dimension ``(L, B, sc, Kv, Dh)`` for one flat per-arena slot stack
        ``(L, n_pages * page, Kv, Dh)`` shared by all rows through per-row
        page tables; everything else keeps its ``(L, B, ...)`` row layout.
        Returns ``(entries, n_pages, sc)``; ``n_pages`` is 0 when no entry
        pages (the SSM family). With a serving ``ctx``, this rank's blocks
        (its rows and kv heads); a cache split along its sequence has no
        paged layout (the reference's paged path runs on one device) and
        raises."""
        ent = self.cache_entries(batch, seq_len, ctx)
        sc = self.attn_cache_len(seq_len)
        has_paged = any(self.is_paged_cache_key(k) for k in ent)
        rows = next((shape[1] for k, (shape, _a, _d) in ent.items()
                     if self.is_paged_cache_key(k)), batch)
        n_pages = rows * -(-sc // page) if has_paged else 0
        out = {}
        for k, (shape, axes, dt) in ent.items():
            if self.is_paged_cache_key(k):
                ll, _b, s_loc, *rest = shape
                if s_loc != sc:
                    raise ValueError(f"{k}: a cache split along its sequence "
                                     f"({s_loc} of {sc} slots a rank) has no paged layout; "
                                     f"the paged path runs on one device's slot stack")
                out[k] = ((ll, n_pages * page, *rest),
                          (axes[0], "kv_slots", *axes[3:]), dt)
            else:
                out[k] = (shape, axes, dt)
        return out, n_pages, sc

    def cache_specs(self, batch: int, seq_len: int, ctx: Optional[ShardCtx] = None):
        """``(specs, axes)`` of the decode cache: meta tensors (with a
        serving ``ctx``, at this rank's block shapes) and each entry's
        logical axes."""
        ent = self.cache_entries(batch, seq_len, ctx)
        specs = {k: torch.empty(s, dtype=d, device="meta") for k, (s, _a, d) in ent.items()}
        return specs, {k: a for k, (_s, a, _d) in ent.items()}

    def init_cache(self, batch: int, seq_len: int, device,
                   ctx: Optional[ShardCtx] = None) -> Dict[str, torch.Tensor]:
        ent = self.cache_entries(batch, seq_len, ctx)
        return {k: torch.zeros(s, dtype=d, device=device) for k, (s, _a, d) in ent.items()}

    def init_paged_cache(self, batch: int, seq_len: int, page: int, device,
                         ctx: Optional[ShardCtx] = None):
        ent, _n_pages, _sc = self.paged_cache_entries(batch, seq_len, page, ctx)
        return {k: torch.zeros(s, dtype=d, device=device) for k, (s, _a, d) in ent.items()}

    def decode_step(self, params, cache: Dict, tokens: torch.Tensor,
                    pos: torch.Tensor, ctx: Optional[ShardCtx] = None, *,
                    window_override: Optional[int] = None,
                    tables: Optional[torch.Tensor] = None, page: int = 0,
                    seq_len: int = 0, decode_kernel: str = "gather"):
        """tokens: (B, 1); pos: scalar or (B,) int32 — rows may sit at
        different generation depths. Returns ``(logits, cache)``; the cache
        tensors are updated in place and returned for the caller's
        convenience. With ``tables``/``page`` the attention K/V in ``cache``
        are flat slot stacks (``paged_cache_entries``) read through the
        (B, max_pages) int32 page table, ``seq_len`` is the bucket context
        the arena was sized for, and ``decode_kernel`` picks the paged read
        (paged | gather | ref; see ``blocks.attn_block_decode``). Recurrent
        layers (SSD, RG-LRU) ignore ``pos``, ``tables`` and the window:
        their state is per row. The hybrid family's attention layers take
        the arch's window, as the reference's do. An encoder-decoder's
        decoder layers read their cross K/V (``cache["x.k"]``,
        ``cache["x.v"]``, per row) after their self-attention. ``ctx`` (a
        serving ``ShardCtx`` over a model axis): ``cache`` is this rank's
        block of it (:meth:`init_cache` with the ``ctx``), the blocks run
        on this rank's parameter blocks and the logits are the whole
        vocab's on every rank."""
        cfg = self.cfg
        tp = ctx is not None and ctx.tp
        params = self._gathered_top(params, ctx)
        x = ctx.leave(self._embed_tp(params, tokens, ctx)) if tp else self._embed(params, tokens)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
        paged = tables is not None and page > 0
        sc = self.attn_cache_len(seq_len) if paged else 0
        if not paged:
            tables, page = None, 0
        if cfg.family == "hybrid":
            # the reference's hybrid decode gives every attention layer the
            # arch's window (rotating cache), whatever the override
            window = cfg.window_size
        elif self.is_ssm:
            window = 0                      # no attention layer
        else:
            slots = cache_seq(cache)
            if ctx is not None and ctx.cache_group is not None:
                slots *= comm.world_size(ctx.cache_group)
            window = (window_override if window_override is not None
                      else self.decode_window(seq_len if paged else slots))
        stacks, lcaches = {}, {}
        for prefix, _n, _b in self._stacks():
            stacks[prefix] = _subtree(params, prefix)
            lcaches[prefix] = _subtree(cache, prefix)
        for kind, prefix, i in self.layers():
            lp = self._layer(stacks[prefix], i)
            if ctx is not None and ctx.gather is not None:
                lp = ctx.gather(prefix, lp)
            lc = self._layer(lcaches[prefix], i)
            if kind == "s":
                x = B.ssd_block_decode(cfg, lp, x, lc, ctx)
            elif kind == "r":
                x = B.rglru_block_decode(cfg, lp, x, lc, ctx)
            else:
                xkv = (cache["x.k"][i], cache["x.v"][i]) if cfg.is_encdec else None
                x = B.attn_block_decode(cfg, lp, x, lc, pos, window=window,
                                        tables=tables, page=page, sc=sc,
                                        decode_kernel=decode_kernel, enc_out_kv=xkv, ctx=ctx)
        x = rms_norm(x, params["final_ln"])
        return (self._whole_logits(params, x, ctx) if tp else self._logits(params, x)), cache

    def build_cross_cache(self, params, frames: torch.Tensor,
                          ctx: Optional[ShardCtx] = None) -> Dict[str, torch.Tensor]:
        """An encoder-decoder's serving setup: the encoder run once over
        ``frames`` ``(B, Senc, D)`` and every decoder layer's cross K/V
        projected from its output: ``{"x.k", "x.v"}``, each ``(L, B, Senc,
        Kv, Dh)`` in the model's dtype, to merge into the decode cache. With
        a serving ``ctx`` over a model axis the encoder runs on this rank's
        parameter blocks and the cross K/V are the cache's block: this
        rank's kv heads under ``cache_heads_over_model``, else all of
        them."""
        if not self.cfg.is_encdec:
            raise ValueError(f"{self.cfg.name} has no encoder")
        params = self._gathered_top(params, ctx)
        enc_out = self._encode(params, frames.to(self.dtype), ctx=ctx)
        wk, wv = params["d.xwk"], params["d.xwv"]
        if ctx is not None and ctx.gather is not None:
            layers = [ctx.gather("d.", {"xwk": a, "xwv": b}) for a, b in zip(wk, wv)]
            wk = torch.stack([lp["xwk"] for lp in layers])
            wv = torch.stack([lp["xwv"] for lp in layers])
        xk = torch.einsum("bsd,ldhk->lbshk", enc_out, wk)
        xv = torch.einsum("bsd,ldhk->lbshk", enc_out, wv)
        if ctx is not None and ctx.tp and not ctx.plan.cache_heads_over_model:
            kv = self.cfg.num_kv_heads
            xk, xv = ctx.whole_dim(xk, 3, kv), ctx.whole_dim(xv, 3, kv)
        return {"x.k": xk.to(self.dtype), "x.v": xv.to(self.dtype)}


def cache_seq(cache: Dict) -> int:
    """The slots of a dense decode cache's self-attention rows (0 without
    attention)."""
    for k, v in cache.items():
        if k.endswith(".k") and not k.startswith("x."):
            return v.shape[2]
    return 0


def gather_cache_slots(kv: torch.Tensor, lengths: torch.Tensor,
                       sc: int) -> torch.Tensor:
    """Map full-sequence K/V ``(L, B, S, Kv, Dh)`` onto decode-cache slots
    ``(L, B, sc, Kv, Dh)``: slot ``i`` of row ``r`` holds the latest prompt
    position ``p ≡ i (mod sc)`` with ``p < lengths[r]`` (the rotating-window
    layout; the identity when ``sc >= S``). Slots with no valid position are
    zeroed."""
    b, s = kv.shape[1], kv.shape[2]
    last = lengths.long()[:, None] - 1                                # (B, 1)
    i = torch.arange(sc, device=kv.device)[None, :]
    p = last - torch.remainder(last - i, sc)                          # (B, sc)
    valid = (p >= 0)[None, :, :, None, None]
    pc = torch.clamp(p, 0, s - 1)
    out = kv[:, torch.arange(b, device=kv.device)[:, None], pc]       # (L, B, sc, ...)
    return torch.where(valid, out, torch.zeros((), dtype=kv.dtype, device=kv.device))


def _rank_block(t: torch.Tensor, block: Tuple[int, ...], key: str,
                ctx: ShardCtx) -> torch.Tensor:
    """This rank's block ``block`` (its shape) of a prompt pass's cache
    entry ``t``: the kv heads of its model rank, the slots of its
    ``ctx.cache_group`` rank (a K/V entry's sequence), or ``t`` where the
    pass already formed the block."""
    for dim, (a, n) in enumerate(zip(t.shape, block)):
        if a == n:
            continue
        if key.endswith((".k", ".v")) and dim == 2:
            lo, _hi = ctx.cache_span(a)
        else:
            lo = ctx.mrank * n
        t = t.narrow(dim, lo, n)
    return t.contiguous()


def build_model(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16) -> Model:
    return Model(cfg, dtype)
