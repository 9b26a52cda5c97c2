"""The attention, Mamba-2 SSD and RG-LRU blocks (port of
``repro/models/blocks.py``).

``*_block_params(cfg)`` gives a block's per-layer specs, ``*_block_apply``
its full-sequence forward (prefill), ``*_block_decode`` its one-token
forward with its in-place cache update. The attention block's FFN is the
dense SwiGLU, for a config with ``num_experts`` the MoE FFN
(:func:`moe_ffn`), and for the audio family Whisper's GELU MLP. An
encoder-decoder's decoder block (``cross=True``) adds cross attention over
the encoder's output after its self-attention.

Each ``*_block_apply`` takes a :class:`~repro_torch.models.common.ShardCtx`
(``ctx``) in a train step over ranks. Over a model axis (``ctx.tp``) the
blocks run on the rank's blocks of their parameters, as the reference's
GSPMD lowering of its sharding constraints does, with the collectives
written out (Megatron's layout, the reference's ``blocks.py:76-175``,
``:253-303``, ``:433-455`` and ``:553-573``): attention column-parallel over
heads and row-parallel out (where the heads do not split the model axis,
under sequence parallelism each rank's queries against all keys, else the
attention whole on every rank); the FFN over ``ffn`` columns; the MoE
FFN's experts over the ranks (routing whole on every rank, each rank's
slots of the capacity buffer, the combine's partial sums reduced like a
row-parallel product); the SSD block over its heads (B and C whole, the
gated norm's mean square summed over the ranks); the RG-LRU block over its
channels (each channel's gates read every channel of the conv output,
all-gathered). A block whose split dims do not divide the model axis runs
whole on every rank.

Serving under a model axis (a serving ``ShardCtx``: the plan's
``DP_TP`` layout, no autograd) takes the same paths: a prompt pass's
``*_block_apply`` over a model axis also returns the decode state in the
serving cache's layout, and each ``*_block_decode`` takes the ``ctx``
(without a model group its boundaries are identities, and the tick is the
one-device tick). Under context-parallel prefill the residual stream is
the rank's block of the prompt: attention runs the rank's queries against
the gathered K/V (:func:`_attention_tp`), the FFN and the MoE FFN gather
the sequence into their per-shard work and reduce-scatter it out, and the
scans (SSD, RG-LRU), which cannot run on a sequence shard, gather the
sequence first, as training's sequence-parallel path does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core import comm
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.rglru_scan import lru_gates_torch
from repro_torch.models import attention as ATT
from repro_torch.models.common import (ShardCtx, causal_conv1d, rms_norm, rms_norm_sharded,
                                       rope, swiglu)

DECODE_KERNELS = ("paged", "gather", "ref")


def attn_block_params(cfg: ModelConfig, cross: bool = False) -> Dict:
    d, hq, kv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    p = {
        "ln1": ((d,), (None,), "ones"),
        "wq": ((d, hq, hd), ("embed", "q_heads", "head_dim"), "normal"),
        "wk": ((d, kv, hd), ("embed", "kv_heads", "head_dim"), "normal"),
        "wv": ((d, kv, hd), ("embed", "kv_heads", "head_dim"), "normal"),
        "wo": ((hq, hd, d), ("q_heads", "head_dim", "embed_out"), "normal"),
        "ln2": ((d,), (None,), "ones"),
    }
    if cross:
        p.update({
            "xln": ((d,), (None,), "ones"),
            "xwq": ((d, hq, hd), ("embed", "q_heads", "head_dim"), "normal"),
            "xwk": ((d, kv, hd), ("embed", "kv_heads", "head_dim"), "normal"),
            "xwv": ((d, kv, hd), ("embed", "kv_heads", "head_dim"), "normal"),
            "xwo": ((hq, hd, d), ("q_heads", "head_dim", "embed_out"), "normal"),
        })
    if cfg.num_experts:
        e = cfg.num_experts
        p.update({
            "router": ((d, e), ("embed", None), "normal"),
            "e_wg": ((e, d, f), ("experts", "embed", "ffn"), "normal"),
            "e_wu": ((e, d, f), ("experts", "embed", "ffn"), "normal"),
            "e_wd": ((e, f, d), ("experts", "ffn", "embed_out"), "normal"),
        })
    elif cfg.family == "audio":
        # Whisper's GELU MLP
        p.update({
            "wi": ((d, f), ("embed", "ffn"), "normal"),
            "wo_mlp": ((f, d), ("ffn", "embed_out"), "normal"),
        })
    else:
        p.update({
            "wg": ((d, f), ("embed", "ffn"), "normal"),
            "wu": ((d, f), ("embed", "ffn"), "normal"),
            "wd": ((f, d), ("ffn", "embed_out"), "normal"),
        })
    return p


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _qkv(cfg: ModelConfig, p: Dict, x: torch.Tensor,
         positions: Optional[torch.Tensor]):
    """Returns rope'd ``(q, k, v)``, K/V in kv-head form ``(B, S, Kv, Dh)`` —
    exactly what a decode cache row stores, so prefill can hand it off."""
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = wo.shape
    return torch.matmul(o.reshape(*o.shape[:-2], h * k), wo.reshape(h * k, d))


def _ffn(cfg: ModelConfig, p: Dict, x: torch.Tensor,
         ctx: Optional[ShardCtx] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFN and its auxiliary loss (0.0 but for the MoE FFN). The audio
    family's GELU (tanh form, as ``jax.nn.gelu``) runs on the float32
    product, which is then cast back, in the reference's order. Over a
    model axis ``x`` is the residual stream's form and so is the result."""
    if cfg.num_experts:
        return moe_ffn(cfg, p, x, ctx)
    if ctx is not None and ctx.tp:
        return _ffn_tp(cfg, p, x, ctx), 0.0
    return _dense_ffn(cfg, p, x), 0.0


def _dense_ffn(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.family == "audio":
        h = F.gelu(torch.matmul(x, p["wi"]).float(), approximate="tanh")
        return torch.matmul(h.to(x.dtype), p["wo_mlp"])
    return swiglu(x, p["wg"], p["wu"], p["wd"])


def _ffn_tp(cfg: ModelConfig, p: Dict, h: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """The dense FFN over a model axis: column-parallel up (``wg``/``wu``,
    or ``wi``) and row-parallel down (``wd``, or ``wo_mlp``); where ``ffn``
    does not split, whole on every rank (under context-parallel prefill on
    the rank's block of the prompt)."""
    up, down = ("wi", "wo_mlp") if cfg.family == "audio" else ("wg", "wd")
    if p[up].shape[1] != cfg.d_ff:
        return ctx.leave(_dense_ffn(cfg, p, ctx.enter(h)))
    q = dict(p, **{down: ctx.rep_param(p[down], 1, cfg.d_model)})
    if ctx.cp:
        # context-parallel prefill (no autograd): the rank's block of the
        # prompt through the whole weights
        return _dense_ffn(cfg, q, h)
    return ctx.rep_out(_dense_ffn(cfg, q, ctx.rep_in(h)))


def _kv_heads(ctx: ShardCtx, w: torch.Tensor, lo: int, hi: int, kv: int) -> torch.Tensor:
    """The kv heads ``[lo, hi)`` of ``wk``/``wv``: the rank's block where the
    rules split the kv heads (then exactly these), else a slice of the
    whole tensor."""
    if w.shape[1] != kv or (lo, hi) == (0, kv):
        return ctx.whole(w) if w.shape[1] == kv else w
    return ctx.whole(w).narrow(1, lo, hi - lo)


def _gqa_local(k: torch.Tensor, v: torch.Tensor, lo: int, hi: int, g: int, k_lo: int):
    """K/V ``(B, S, n_kv, D)`` (kv heads from ``k_lo``) for the query heads
    ``[lo, hi)``: as they are where each kv head serves an equal run of
    them, else gathered to one kv head per query head."""
    idx = [(h // g) - k_lo for h in range(lo, hi)]
    nq, nkv = hi - lo, k.shape[2]
    if nq % nkv == 0 and idx == [j // (nq // nkv) for j in range(nq)]:
        return k, v
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def _attention_tp(cfg: ModelConfig, p: Dict, h: torch.Tensor, kv_in: torch.Tensor,
                  positions: Optional[torch.Tensor], ctx: ShardCtx, names: Tuple[str, ...],
                  *, causal: bool, window: int):
    """Attention over a model axis, queries from ``h`` and K/V from
    ``kv_in`` (``h`` itself, or the encoder's output), both in the residual
    stream's form; returns the output projection in that form and the
    rope'd K/V ``(B, S, n, Dh)`` over the whole sequence, which a prompt
    pass hands to the cache. ``positions`` (the whole sequence's) rope the
    queries and keys, None for none.

    Heads split over the ranks: each rank's q heads and the kv heads they
    read, row-parallel ``wo`` (where the serving cache keeps every kv head,
    ``ctx.cache_group``, all of them are projected). Heads that do not
    split, under sequence parallelism, and context-parallel prefill
    (``ctx.cp``): this rank's query positions against the gathered K/V at
    ``q_offset`` (the reference's SP attention; under context parallelism
    each rank projects its block's K/V, gathered along the sequence, with
    the weights gathered where the rules split them). Otherwise the
    attention whole on every rank."""
    wq, wk, wv, wo = (p[n] for n in names)
    hq, kv, d, hd = cfg.num_heads, cfg.num_kv_heads, cfg.d_model, cfg.head_dim
    g = hq // kv
    if wq.shape[1] != hq and not ctx.cp:
        hf = ctx.enter(h)
        kf = hf if kv_in is h else ctx.enter(kv_in)
        lo, hi = ctx.span(hq)
        k_lo, k_hi = lo // g, (hi - 1) // g + 1
        if ctx.cache_group is not None:
            k_lo, k_hi = 0, kv
        q = _proj_heads(hf, wq)
        k = _proj_heads(kf, _kv_heads(ctx, wk, k_lo, k_hi, kv))
        v = _proj_heads(kf, _kv_heads(ctx, wv, k_lo, k_hi, kv))
        if positions is not None:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        kl, vl = _gqa_local(k, v, lo, hi, g, k_lo)
        o = ATT.attention(q, kl, vl, causal=causal, window=window)
        return ctx.leave(_out_proj(o, wo)), (k, v)
    if ctx.sp:
        off = ctx.seq_offset(h.shape[1])
        q = _proj_heads(h, ctx.joined(wq, (d, hq, hd)))
        if ctx.cp:
            k = _proj_heads(kv_in, ctx.joined(wk, (d, kv, hd)))
            v = _proj_heads(kv_in, ctx.joined(wv, (d, kv, hd)))
            if positions is not None:
                k = rope(k, positions[off:off + kv_in.shape[1]], cfg.rope_theta)
            k = comm.AllGatherDim.apply(k, 1, ctx.model_group)
            v = comm.AllGatherDim.apply(v, 1, ctx.model_group)
        else:
            kf = ctx.enter(kv_in)
            k = _proj_heads(kf, ctx.joined(wk, (d, kv, hd)))
            v = _proj_heads(kf, ctx.joined(wv, (d, kv, hd)))
            if positions is not None:
                k = rope(k, positions, cfg.rope_theta)
        if positions is not None:
            q = rope(q, positions[off:off + h.shape[1]], cfg.rope_theta)
        o = ATT.attention(q, k, v, causal=causal, window=window, q_offset=off)
        return _out_proj(o, ctx.joined(wo, (hq, hd, d))), (k, v)
    q = _proj_heads(h, wq)
    k = _proj_heads(kv_in, wk)
    v = _proj_heads(kv_in, wv)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = ATT.attention(q, k, v, causal=causal, window=window)
    return _out_proj(o, ctx.rep_param(wo, 2, d)), (k, v)


def _attn_block_tp(cfg: ModelConfig, p: Dict, x: torch.Tensor, positions: torch.Tensor,
                   ctx: ShardCtx, *, causal: bool, window: int,
                   enc_out: Optional[torch.Tensor]):
    """:func:`attn_block_apply` over a model axis; ``x`` is the residual
    stream (under sequence parallelism this rank's shard of it) and
    ``positions`` the whole sequence's. The K/V are those
    :func:`_attention_tp` projected (the prompt pass's cache)."""
    h = rms_norm(x, ctx.gain(p["ln1"]))
    a, (k, v) = _attention_tp(cfg, p, h, h, positions, ctx, ("wq", "wk", "wv", "wo"),
                              causal=causal, window=window)
    x = x + a
    if enc_out is not None:
        h = rms_norm(x, ctx.gain(p["xln"]))
        x = x + _attention_tp(cfg, p, h, enc_out, None, ctx, ("xwq", "xwk", "xwv", "xwo"),
                              causal=False, window=0)[0]
    f, aux = _ffn(cfg, p, rms_norm(x, ctx.gain(p["ln2"])), ctx)
    return x + f, aux, {"k": k, "v": v}


def _attn_out(o: torch.Tensor, wo: torch.Tensor, hq: int, d: int,
              ctx: ShardCtx) -> torch.Tensor:
    """The output projection of a decode tick's attention ``o`` over this
    rank's q heads: row-parallel and summed over the model group where the
    heads split, else whole on every rank (``wo``'s output columns
    gathered where the rules split them)."""
    out = _out_proj(o, wo)
    return ctx.leave(out) if wo.shape[0] != hq else ctx.whole_dim(out, 2, d)


def _cross(cfg: ModelConfig, p: Dict, x: torch.Tensor, kx: torch.Tensor, vx: torch.Tensor,
           ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """The residual stream after cross attention: queries from ``x`` (no
    rope) over the encoder's K/V ``(B, Senc, Kv, Dh)`` in kv-head form,
    every key seen (``causal=False``): on a CUDA tensor the flash kernel, or
    at one query row (a decode tick) ``flash_decode``, which reads the K/V
    in place. Under a serving ``ctx`` over a model axis: this rank's q
    heads over the kv heads they read (the cross cache's head block, or
    those heads of a whole one)."""
    ctx = ctx or ShardCtx()
    hq, kv = cfg.num_heads, cfg.num_kv_heads
    g = hq // kv
    lo, hi = ctx.span(hq) if p["xwq"].shape[1] != hq else (0, hq)
    k_lo, k_hi = lo // g, (hi - 1) // g + 1
    if kx.shape[2] != k_hi - k_lo:
        kx, vx = kx[:, :, k_lo:k_hi], vx[:, :, k_lo:k_hi]
    kx, vx = _gqa_local(kx, vx, lo, hi, g, k_lo)
    qx = _proj_heads(rms_norm(x, p["xln"]), p["xwq"])
    ox = ATT.attention(qx, kx, vx, causal=False)
    return x + _attn_out(ox, p["xwo"], hq, cfg.d_model, ctx)


def attn_block_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                     positions: torch.Tensor, *, causal: bool = True,
                     window: int = 0, ctx: Optional[ShardCtx] = None,
                     enc_out: Optional[torch.Tensor] = None):
    """Full-sequence forward. Returns ``(x_out, aux, {"k", "v"})``: the
    FFN's auxiliary loss (the MoE load-balance loss, else 0) and the rope'd
    K/V in kv-head cache-row form ``(B, S, Kv, Dh)`` for the prefill→decode
    handoff. With ``enc_out`` (an encoder-decoder's decoder block) cross
    attention over it follows the self-attention. Over a model axis
    (``ctx.tp``): :func:`_attn_block_tp`, whose K/V are the heads this rank
    projected over the whole sequence."""
    if ctx is not None and ctx.tp:
        return _attn_block_tp(cfg, p, x, positions, ctx, causal=causal, window=window,
                              enc_out=enc_out)
    h = rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h, positions)
    o = ATT.attention(q, k, v, causal=causal, window=window)
    x = x + _out_proj(o, p["wo"])
    if enc_out is not None:
        x = _cross(cfg, p, x, _proj_heads(enc_out, p["xwk"]), _proj_heads(enc_out, p["xwv"]))
    f, aux = _ffn(cfg, p, rms_norm(x, p["ln2"]), ctx)
    return x + f, aux, {"k": k, "v": v}


def attn_block_decode(
    cfg: ModelConfig, p: Dict, x: torch.Tensor, cache: Dict, pos: torch.Tensor,
    *, window: int = 0, tables: Optional[torch.Tensor] = None, page: int = 0,
    sc: int = 0, decode_kernel: str = "gather",
    enc_out_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ctx: Optional[ShardCtx] = None,
) -> torch.Tensor:
    """x: (B, 1, D). cache: {"k", "v"} — dense ``(B, Sc, Kv, Dh)`` rows, or
    with ``tables``/``page``/``sc`` flat ``(n_slots, Kv, Dh)`` slot stacks
    read through each row's page table. The cache is written in place.
    ``pos`` is a scalar or a (B,) int32 vector. ``decode_kernel`` picks the
    paged read: "paged" (the fused kernel through ``kernels.ops``),
    "gather" (gathered view + dense decode attention) or "ref" (the
    oracle). ``enc_out_kv``: the layer's cross K/V ``(B, Senc, Kv, Dh)``
    (an encoder-decoder's decoder block), read after the self-attention
    through the same attention op as the prompt pass: on the card
    ``flash_decode``, the one-row kernel, which reads the layer's cross K/V
    where the cache holds them.

    Under a serving ``ctx`` over a model axis the block runs on this rank's
    q heads. A cache on kv heads (``cache_heads_over_model``) holds the kv
    heads those q heads read, and the tick is the one-device tick on them
    (paged or dense), its output projection summed over the model group. A
    cache split along its sequence (``ctx.cache_group``) holds every kv
    head of this rank's slots: the new K/V land on the rank that holds the
    slot, every q head (gathered) attends to the rank's slots, and the
    partial results merge over the group (:meth:`ShardCtx.merge_attention`);
    the paged read of such a cache raises."""
    ctx = ctx or ShardCtx()
    hq, kv = cfg.num_heads, cfg.num_kv_heads
    g = hq // kv
    lo, hi = ctx.span(hq) if p["wq"].shape[1] != hq else (0, hq)
    h = rms_norm(x, p["ln1"])
    rope_pos = pos[None] if pos.dim() == 0 else pos[:, None]
    q = rope(_proj_heads(h, p["wq"]), rope_pos, cfg.rope_theta)
    if ctx.cache_group is None:
        k_lo, k_hi = lo // g, (hi - 1) // g + 1
        if cache["k"].shape[-2] != k_hi - k_lo:
            raise NotImplementedError(
                f"a decode cache of {cache['k'].shape[-2]} kv heads under q heads [{lo}, {hi}): "
                f"a cache over a model axis is split on kv heads or along its sequence")
        k = rope(_proj_heads(h, _kv_heads(ctx, p["wk"], k_lo, k_hi, kv)), rope_pos,
                 cfg.rope_theta)
        v = _proj_heads(h, _kv_heads(ctx, p["wv"], k_lo, k_hi, kv))
        o = _decode_attend(q, k, v, cache, pos, window=window, tables=tables, page=page,
                           sc=sc, decode_kernel=decode_kernel)
    else:
        if tables is not None:
            raise ValueError("paged decode reads one device's slot stack through its page "
                             "table; a cache split along its sequence over ranks decodes "
                             "from its dense rows")
        k = rope(_proj_heads(h, _kv_heads(ctx, p["wk"], 0, kv, kv)), rope_pos, cfg.rope_theta)
        v = _proj_heads(h, _kv_heads(ctx, p["wv"], 0, kv, kv))
        o = _split_cache_attend(ctx.whole_dim(q, 2, hq), k, v, cache, pos, window,
                                ctx)[:, :, lo:hi]
    x = x + _attn_out(o, p["wo"], hq, cfg.d_model, ctx)
    if enc_out_kv is not None:
        x = _cross(cfg, p, x, *enc_out_kv, ctx)
    f, _aux = _ffn(cfg, p, rms_norm(x, p["ln2"]), ctx)       # decode drops aux
    return x + f


def _decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: Dict,
                   pos: torch.Tensor, *, window: int, tables: Optional[torch.Tensor],
                   page: int, sc: int, decode_kernel: str) -> torch.Tensor:
    """One decode tick's attention of ``q`` (B, 1, Hq, Dh) after writing
    ``k``/``v`` (B, 1, Kv, Dh) into ``cache`` (dense rows, or paged slot
    stacks through ``tables``): (B, 1, Hq, Dh)."""
    g = q.shape[2] // k.shape[2]
    if tables is not None:
        kc, vc = ATT.paged_cache_write(cache["k"], cache["v"], k, v, pos,
                                       tables, page, sc, window=window)
        if decode_kernel == "paged":
            # committed-slot mask == decode validity mask for both dense and
            # rotating rows (kernels/paged_attention.py), so the fused op
            # needs pos and sc but not the window
            posb = pos.reshape(-1).expand(q.shape[0]).contiguous()
            return kops.paged_attention(q.contiguous(), kc, vc, tables, posb,
                                        page=page, sc=sc)
        if decode_kernel == "ref":
            return kref.paged_decode_ref(q, kc, vc, tables, pos, page=page, sc=sc,
                                         window=window)
        if decode_kernel != "gather":
            raise ValueError(f"decode_kernel must be one of {DECODE_KERNELS}, "
                             f"got {decode_kernel!r}")
        ke, ve = ATT.paged_gather_kv(kc, vc, tables, page, sc, pos=pos)
    else:
        ke, ve = ATT.cache_write(cache["k"], cache["v"], k, v, pos, window=window)
    if g > 1:
        ke = ke.repeat_interleave(g, dim=2)
        ve = ve.repeat_interleave(g, dim=2)
    return ATT.decode_attention(q, ke, ve, pos, window=window)


def _split_cache_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: Dict,
                        pos: torch.Tensor, window: int, ctx: ShardCtx) -> torch.Tensor:
    """A decode tick over a dense cache whose slots are split evenly over
    ``ctx.cache_group``: ``cache`` holds this rank's ``Sc / n`` slots of
    every kv head. ``q`` (B, 1, Hq, Dh) every q head, ``k``/``v`` (B, 1,
    Kv, Dh) every kv head. The new K/V are written where their slot is this
    rank's (as :func:`attention.cache_write` places them in the whole
    cache), then the rank's slots' scores (the validity mask of
    :func:`attention.decode_attention` at the slots' whole-cache indices)
    merge with the other ranks' (:meth:`ShardCtx.merge_attention`)."""
    kc, vc = cache["k"], cache["v"]
    b, sl = kc.shape[0], kc.shape[1]
    n = sl * comm.world_size(ctx.cache_group)
    s_lo, _s_hi = ctx.cache_span(n)
    posb = pos.reshape(-1).long().expand(b)
    slot = torch.remainder(posb, n) if window else posb
    if not window and pos.dim() == 0:
        slot = torch.clamp(slot, 0, n - 1)    # the dense write's clamp of a shared slot
    local = slot - s_lo
    keep = (local >= 0) & (local < sl)
    flat = torch.arange(b, device=kc.device) * sl + torch.clamp(local, 0, sl - 1)
    ATT._write_kept(kc.view(b * sl, *kc.shape[2:]), flat, keep, k[:, 0].to(kc.dtype))
    ATT._write_kept(vc.view(b * sl, *vc.shape[2:]), flat, keep, v[:, 0].to(vc.dtype))
    g = q.shape[2] // kc.shape[2]
    ke = kc.repeat_interleave(g, dim=2) if g > 1 else kc
    ve = vc.repeat_interleave(g, dim=2) if g > 1 else vc
    qf = (q.float() * (q.shape[-1] ** -0.5))[:, 0]
    s = torch.einsum("bhd,bkhd->bhk", qf, ke.float())
    slots = s_lo + torch.arange(sl, device=kc.device)[None, :]
    pb = posb[:, None]
    if window:
        p_i = pb - torch.remainder(pb - slots, n)
        valid = (p_i >= 0) & (p_i <= pb)
    else:
        valid = slots <= pb
    s = torch.where(valid[:, None, :], s, torch.full((), ATT.NEG_INF, device=kc.device))
    return ctx.merge_attention(s, ve)[:, None].to(q.dtype)


def attn_cache_spec(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    """Per-layer cache shapes + logical axes."""
    kvshape = (batch, seq, cfg.num_kv_heads, cfg.head_dim)
    axes = ("batch", "seq", "kv_heads", "head_dim")
    return {"k": (kvshape, axes), "v": (kvshape, axes)}


# ===========================================================================
# MoE FFN: sort-based grouped dispatch into a static capacity buffer
# ===========================================================================


def moe_ffn(cfg: ModelConfig, p: Dict, x: torch.Tensor,
            ctx: Optional[ShardCtx] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux), the reference's ``moe_ffn``.

    Top-k routing on float32 softmax probabilities with renormalised gates,
    a Switch-style load-balance loss from the top-1 density, then the
    tokens sorted by expert into a static ``(E, C, D)`` buffer (tokens past
    an expert's capacity ``C`` are dropped), three batched expert products
    with SiLU, and the gate-weighted combine. Dispatch and combine are
    gathers both ways (:func:`routing_tables`); their backward passes are
    the reference's gathers too.

    The reference splits the tokens into one group per data shard (one on
    one device) and routes each group with the capacity of its own tokens.
    Here every call routes its tokens as one group: on a data mesh each rank
    holds one data shard's rows, so routing on the rank is that grouping.
    ``ctx.ranks_mean`` (a mean over those ranks, with its gradient) makes
    the load-balance statistics global, as the reference's means over the
    mesh's whole batch are.

    Over a model axis (``ctx.tp``) every model rank routes the data shard's
    tokens whole (under sequence parallelism gathered first), so routing,
    capacity and tables are the same on each; a rank with experts split
    over the ranks dispatches to, runs and combines its own experts' slots
    of the buffer (with ``ffn`` split instead, every expert's columns), and
    the combine's partial sums are reduced like a row-parallel product.

    Everything is static in shape and free of host syncs (the capacity is
    Python arithmetic on shapes), so a decode tick that runs it captures in
    one CUDA graph."""
    if ctx is not None and ctx.tp:
        return _moe_tp(cfg, p, x, ctx)
    b, s, d = x.shape
    kk = cfg.experts_per_token
    xf = x.reshape(b * s, d)
    wj, aux, cap, tables = _route(cfg, p, xf, None if ctx is None else ctx.ranks_mean)
    y = _experts(cfg, p, xf, wj, cap, tables, kk)
    return y.reshape(b, s, d), aux


def _route(cfg: ModelConfig, p: Dict, xf: torch.Tensor, ranks_mean):
    """Routing of tokens ``xf`` (T, D) as one group: ``(gates (T * k,) in
    the activation dtype, aux, capacity, routing tables)``."""
    e, kk = cfg.num_experts, cfg.experts_per_token
    t = xf.shape[0]
    # logits in the activation dtype, then float32 (bf16 routing sees the
    # reference's logits)
    logits = torch.matmul(xf, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: the k largest, the lower index first on ties; torch.topk
    # promises no tie order, a stable descending sort does
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :kk], order[:, :kk]
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)

    # Switch-style load-balance aux loss
    experts = torch.arange(e, device=xf.device)
    density = (idx[:, :1] == experts).float().mean(dim=0)
    prob_mean = probs.mean(dim=0)
    if ranks_mean is not None:
        density, prob_mean = ranks_mean(density), ranks_mean(prob_mean)
    aux = e * torch.sum(density * prob_mean)

    cap = int(t * kk * cfg.moe_capacity_factor / e) + 1  # lint: allow-tracer-host-sync (shapes)
    cap = max(8, -(-cap // 8) * 8)
    tables = routing_tables(idx.reshape(t * kk), e, cap)
    return gates.reshape(t * kk).to(xf.dtype), aux, cap, tables


def _experts(cfg: ModelConfig, p: Dict, xf: torch.Tensor, wj: torch.Tensor, cap: int,
             tables, kk: int) -> torch.Tensor:
    """Dispatch into the slots ``tables`` name (``p``'s experts, ``cap``
    slots each), the three expert products and the combine: (T, D)."""
    e, d = p["e_wg"].shape[0], xf.shape[1]
    buf = _MoEDispatch.apply(xf, kk, *tables).view(e, cap, d)
    gm = torch.matmul(buf, p["e_wg"])                              # (E, C, F)
    um = torch.matmul(buf, p["e_wu"])
    hsil = F.silu(gm.float()).to(xf.dtype) * um
    out_buf = torch.matmul(hsil, p["e_wd"])                        # (E, C, D)
    return _MoECombine.apply(out_buf.reshape(e * cap, d), wj, kk, *tables)


def _moe_tp(cfg: ModelConfig, p: Dict, x: torch.Tensor, ctx: ShardCtx):
    """:func:`moe_ffn` over a model axis; ``x`` in the residual stream's form."""
    e, f, kk = cfg.num_experts, cfg.d_ff, cfg.experts_per_token
    h = ctx.rep_in(x)
    b, s, d = h.shape
    xf = h.reshape(b * s, d)
    wj, aux, cap, tables = _route(cfg, p, xf, ctx.ranks_mean)
    e_loc = p["e_wg"].shape[0]
    if e_loc == e and p["e_wg"].shape[2] == f:
        # neither the experts nor their columns split: whole on every rank
        y = _experts(cfg, p, xf, wj, cap, tables, kk)
        return ctx.rep_out(y.reshape(b, s, d)), aux
    if e_loc != e:
        tables = _slot_window(tables, ctx.mrank * e_loc * cap, e_loc * cap)
    y = _experts(cfg, p, ctx.whole(xf), ctx.whole(wj), cap, tables, kk)
    return ctx.leave(y.reshape(b, s, d)), aux


def _slot_window(tables, lo: int, n: int):
    """The routing tables of slots ``[lo, lo + n)`` alone (one rank's
    experts): slot indices from ``lo``, and a (token, k) pair valid only
    where its slot is in the window."""
    j_of_slot, s_valid, slot_of_j, j_valid = tables
    inside = (slot_of_j >= lo) & (slot_of_j < lo + n)
    return (j_of_slot[lo:lo + n], s_valid[lo:lo + n], (slot_of_j - lo).clamp(0, n - 1),
            j_valid & inside)


def routing_tables(flat_e: torch.Tensor, e: int, cap: int) -> Tuple[torch.Tensor, ...]:
    """Gather-only routing tables of one group, the reference's
    ``_routing_tables``. ``flat_e`` (T*k,) is the expert of each (token, k)
    pair, "j" in token-major order. Returns ``(j_of_slot, s_valid,
    slot_of_j, j_valid)``: both directions of the token <-> slot
    permutation over the ``(E * cap)`` slots, so dispatch, combine and their
    gradients are all gathers. Within an expert the slots follow j's order
    (a stable sort), and j past an expert's ``cap`` slots is dropped."""
    tgk = flat_e.shape[0]
    dev = flat_e.device
    order = torch.argsort(flat_e, stable=True)                     # sorted position -> j
    inv = torch.argsort(order)                                     # j -> sorted position
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e + 1, device=dev))
    # slot -> j
    slot_ids = torch.arange(e * cap, device=dev)
    s_e, s_c = slot_ids // cap, slot_ids % cap
    spos = starts[s_e] + s_c
    s_valid = spos < starts[s_e + 1]
    j_of_slot = order[torch.clamp(spos, 0, tgk - 1)]
    # j -> slot
    pos_in_e = inv - starts[flat_e]
    slot_of_j = flat_e * cap + torch.clamp(pos_in_e, max=cap - 1)
    j_valid = pos_in_e < cap
    return j_of_slot, s_valid, slot_of_j, j_valid


class _MoEDispatch(torch.autograd.Function):
    """Tokens (T, D) -> the slot buffer (E * cap, D): slot i holds token
    ``j_of_slot[i] // k``, zeros where the slot is empty. The gradient is
    the reference's gather: each token sums, over its k pairs, the slot
    gradient of the slot that pair holds (none where the pair was dropped),
    in the buffer's dtype."""

    @staticmethod
    def forward(ctx, xg, kk, j_of_slot, s_valid, slot_of_j, j_valid):
        ctx.kk, ctx.tokens = kk, xg.shape[0]
        ctx.save_for_backward(slot_of_j, j_valid)
        return xg[j_of_slot // kk] * s_valid[:, None].to(xg.dtype)

    @staticmethod
    def backward(ctx, d_buf):
        slot_of_j, j_valid = ctx.saved_tensors
        vals = d_buf[slot_of_j] * j_valid[:, None].to(d_buf.dtype)
        dx = vals.reshape(ctx.tokens, ctx.kk, d_buf.shape[1]).sum(dim=1).to(d_buf.dtype)
        return dx, None, None, None, None, None


class _MoECombine(torch.autograd.Function):
    """The slot outputs (E * cap, D) and the gates (T * k,) -> tokens
    (T, D): each token sums its k pairs' slot outputs weighted by their
    gates (a dropped pair adds nothing). The gradients are the reference's
    gathers: a slot's output gradient is its token's gradient times its
    pair's gate; a pair's gate gradient is the dot of its slot's output
    with its token's gradient."""

    @staticmethod
    def forward(ctx, out_flat, wj, kk, j_of_slot, s_valid, slot_of_j, j_valid):
        ctx.kk = kk
        ctx.save_for_backward(out_flat, wj, j_of_slot, s_valid, slot_of_j, j_valid)
        vals = out_flat[slot_of_j] * (wj * j_valid.to(wj.dtype))[:, None]
        return vals.reshape(wj.shape[0] // kk, kk, out_flat.shape[1]).sum(dim=1)

    @staticmethod
    def backward(ctx, dy):
        out_flat, wj, j_of_slot, s_valid, slot_of_j, j_valid = ctx.saved_tensors
        kk = ctx.kk
        dyj = dy[j_of_slot // kk]
        wslot = wj[j_of_slot] * s_valid.to(wj.dtype)
        d_out = (dyj * wslot[:, None]).to(out_flat.dtype)
        dy_rep = dy.repeat_interleave(kk, dim=0)                   # j-order tokens
        d_w = torch.sum(out_flat[slot_of_j] * dy_rep, dim=-1) * j_valid.to(wj.dtype)
        return d_out, d_w.to(wj.dtype), None, None, None, None, None


# ===========================================================================
# Mamba-2 SSD block
# ===========================================================================


def ssd_block_params(cfg: ModelConfig) -> Dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_num_heads
    wc = cfg.ssm_conv_width
    return {
        "ln": ((d,), (None,), "ones"),
        "wz": ((d, di), ("embed", "ssm_inner"), "normal"),
        "wx": ((d, di), ("embed", "ssm_inner"), "normal"),
        "wb": ((d, n), ("embed", None), "normal"),
        "wc": ((d, n), ("embed", None), "normal"),
        "wdt": ((d, h), ("embed", "ssm_heads"), "normal"),
        "dt_bias": ((h,), (None,), "zeros"),
        "conv_x": ((wc, di), ("conv", "ssm_inner"), "normal"),
        "conv_b": ((wc, n), ("conv", None), "normal"),
        "conv_c": ((wc, n), ("conv", None), "normal"),
        "a_log": ((h,), (None,), "ssm_a"),
        "d_skip": ((h,), (None,), "ones"),
        "gate_ln": ((di,), (None,), "ones"),
        "w_out": ((di, d), ("ssm_inner", "embed_out"), "normal"),
    }


def _ssd_pre(cfg: ModelConfig, p: Dict, h: torch.Tensor):
    """Input projections: z, x, B, C in the model dtype and the softplus'd
    step sizes dt in float32."""
    z = torch.matmul(h, p["wz"])
    xin = torch.matmul(h, p["wx"])
    bm = torch.matmul(h, p["wb"])
    cm = torch.matmul(h, p["wc"])
    dt = F.softplus(torch.matmul(h, p["wdt"]).float() + p["dt_bias"].float())
    return z, xin, bm, cm, dt


def _conv_tail(x_raw: torch.Tensor, wd: int, lengths: torch.Tensor) -> torch.Tensor:
    """Decode conv state after a prefill of per-row length T: the last
    ``wd - 1`` raw pre-conv inputs before position T (zeros below position
    0). x_raw (B, S, C), lengths (B,) -> (B, wd-1, C)."""
    b = x_raw.shape[0]
    xp = F.pad(x_raw, (0, 0, wd - 1, 0))            # index j <-> position j-(wd-1)
    idx = lengths.long()[:, None] + torch.arange(wd - 1, device=x_raw.device)[None, :]
    return xp[torch.arange(b, device=x_raw.device)[:, None], idx]


def _decay_rates(p: Dict) -> torch.Tensor:
    """Per-head A = -exp(a_log), float32 and negative."""
    return -torch.exp(p["a_log"].float())


def _gate_out(cfg: ModelConfig, p: Dict, x: torch.Tensor, y: torch.Tensor,
              z: torch.Tensor, ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """Gated RMSNorm of the SSD output, the output projection and the
    residual; over a model axis (a serving ``ctx``) the norm over the
    whole inner width and the row-parallel projection summed."""
    y = y * F.silu(z.float()).to(x.dtype)
    if ctx is not None and ctx.tp:
        y = rms_norm_sharded(y, ctx.part(p["gate_ln"], 0, cfg.d_inner), cfg.d_inner,
                             ctx.model_group)
        return x + ctx.leave(torch.matmul(y, p["w_out"]))
    return x + torch.matmul(rms_norm(y, p["gate_ln"]), p["w_out"])


def _whole_params(p: Dict, full: Dict, ctx: ShardCtx) -> Dict:
    """A block's parameters whole on every model rank: each one the rules
    split all-gathered (its gradient kept to this rank's block)."""
    q = {}
    for k, t in p.items():
        dims = [i for i, (a, n) in enumerate(zip(t.shape, full[k][0])) if a != n]
        q[k] = ctx.rep_param(t, dims[0], full[k][0][dims[0]]) if dims else t
    return q


def _whole_block(fn, cfg: ModelConfig, p: Dict, x: torch.Tensor, full: Dict,
                 ctx: ShardCtx, **kw):
    """``fn(cfg, p, x)`` run whole on every model rank, for a block whose
    split dims do not divide the model axis: each parameter the rules
    split gathered, the residual stream's sequence shards gathered under
    sequence parallelism. With ``want_cache`` in ``kw`` the decode state
    comes back whole."""
    out = fn(cfg, _whole_params(p, full, ctx), ctx.rep_in(x), **kw)
    if kw.get("want_cache"):
        return ctx.rep_out(out[0]), out[1]
    return ctx.rep_out(out)


def _split(p: Dict, full: Dict, names: Tuple[str, ...]) -> bool:
    """Whether the rules split every one of ``names`` over the model axis."""
    return all(tuple(p[k].shape) != full[k][0] for k in names)


def _ssd_block_tp(cfg: ModelConfig, p: Dict, x: torch.Tensor, ctx: ShardCtx,
                  lengths: Optional[torch.Tensor] = None, want_cache: bool = False):
    """:func:`ssd_block_apply` over a model axis: each rank its block of the
    heads (``wz``, ``wx``, ``conv_x``, ``wdt``, ``w_out`` split over
    ``ssm_inner`` / ``ssm_heads``; ``dt_bias``, ``a_log``, ``d_skip`` and
    ``gate_ln`` sliced from their whole tensors), B and C whole on every
    rank, the gated RMS norm over the whole inner width. Under sequence
    parallelism (and context-parallel prefill) the scan runs on the
    gathered sequence. With ``want_cache`` the decode state of the
    serving cache's layout: this rank's heads of the SSM state, the conv
    tails whole (``conv_x`` gathered over the model group)."""
    full = ssd_block_params(cfg)
    if not _split(p, full, ("wz", "wx", "conv_x", "wdt", "w_out")):
        return _whole_block(ssd_block_apply, cfg, p, x, full, ctx,
                            **({"lengths": lengths, "want_cache": True} if want_cache else {}))
    di, nh, hd = cfg.d_inner, cfg.ssm_num_heads, cfg.ssm_head_dim
    h = ctx.enter(rms_norm(x, ctx.gain(p["ln"])))
    b, s, _d = h.shape
    z = torch.matmul(h, p["wz"])
    xin_raw = torch.matmul(h, p["wx"])
    bm_raw = torch.matmul(h, ctx.whole(p["wb"]))
    cm_raw = torch.matmul(h, ctx.whole(p["wc"]))
    dt = F.softplus(torch.matmul(h, p["wdt"]).float() + ctx.part(p["dt_bias"], 0, nh).float())
    xin_f = F.silu(causal_conv1d(xin_raw, p["conv_x"]).float())
    bm_f = F.silu(causal_conv1d(bm_raw, ctx.whole(p["conv_b"])).float())
    xin, bm = xin_f.to(x.dtype), bm_f.to(x.dtype)
    cm = F.silu(causal_conv1d(cm_raw, ctx.whole(p["conv_c"])).float()).to(x.dtype)
    a = -torch.exp(ctx.part(p["a_log"], 0, nh).float())
    hl = dt.shape[-1]
    y = kops.ssd(xin.reshape(b, s, hl, hd), dt, a, bm, cm,
                 ctx.part(p["d_skip"], 0, nh).float()).reshape(b, s, hl * hd)
    out = _gate_out(cfg, p, x, y, z, ctx)
    if not want_cache:
        return out
    cache = _ssd_state_cache(cfg, dt, a, xin_f, bm_f, xin_raw, bm_raw, cm_raw, lengths)
    cache["conv_x"] = ctx.whole_dim(cache["conv_x"], 2, di)
    return out, cache


def _ssd_state_cache(cfg: ModelConfig, dt: torch.Tensor, a: torch.Tensor,
                     xin_f: torch.Tensor, bm_f: torch.Tensor, xin_raw: torch.Tensor,
                     bm_raw: torch.Tensor, cm_raw: torch.Tensor,
                     lengths: Optional[torch.Tensor]) -> Dict:
    """The decode state after a per-row prompt of ``lengths`` tokens, from
    a prompt pass's step sizes ``dt`` (B, S, H) and decay rates ``a`` (H,)
    of its heads, the unrounded float32 post-conv x (B, S, H * P) and B,
    and the raw pre-conv inputs of the conv tails."""
    b, s, nh = dt.shape
    hd = cfg.ssm_head_dim
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=dt.device)
    # Final SSM state at per-row prompt length T, in closed form:
    #   state_T = sum_{t<T} exp(sum_{u=t+1..T-1} dt_u a) dt_t x_t (x) b_t
    # via log-space prefix sums: no per-position states are held.
    rows = torch.arange(b, device=dt.device)
    cum = torch.cumsum(dt * a[None, None, :], dim=1)                # (B, S, H), <= 0
    cum_t = cum[rows, lengths.long() - 1][:, None, :]                 # (B, 1, H)
    tmask = torch.arange(s, device=dt.device)[None, :] < lengths[:, None]
    w = torch.exp(torch.clamp(cum_t - cum, max=0.0)) * tmask[..., None]
    wx = (w * dt)[..., None] * xin_f.reshape(b, s, nh, hd)           # (B, S, H, P)
    # one (H P, S) @ (S, N) product per row: B is shared by every head, so
    # it is never expanded to (B, H, S, N)
    state = torch.matmul(wx.reshape(b, s, nh * hd).transpose(1, 2),
                         bm_f).reshape(b, nh, hd, -1)                # (B, H, P, N)
    wc = cfg.ssm_conv_width
    return {
        "state": state,
        "conv_x": _conv_tail(xin_raw, wc, lengths),
        "conv_b": _conv_tail(bm_raw, wc, lengths),
        "conv_c": _conv_tail(cm_raw, wc, lengths),
    }


def ssd_block_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
                    lengths: Optional[torch.Tensor] = None,
                    want_cache: bool = False, ctx: Optional[ShardCtx] = None):
    """Full-sequence forward. Returns ``x_out``, or with ``want_cache``
    ``(x_out, cache)`` where cache is the decode state after a per-row
    prompt of ``lengths`` tokens — {"state", "conv_x", "conv_b", "conv_c"}
    exactly as :func:`ssd_block_decode` consumes them. x, B and C enter the
    scan rounded to the model dtype (their gradients formed in float32 and
    rounded once, by the scan's backward); the prefill state is formed from
    their unrounded float32 values, as the reference does. Over a model
    axis (``ctx.tp``): :func:`_ssd_block_tp`."""
    if ctx is not None and ctx.tp:
        return _ssd_block_tp(cfg, p, x, ctx, lengths, want_cache)
    b, s, _d = x.shape
    h = rms_norm(x, p["ln"])
    z, xin_raw, bm_raw, cm_raw, dt = _ssd_pre(cfg, p, h)
    xin_f = F.silu(causal_conv1d(xin_raw, p["conv_x"]).float())
    bm_f = F.silu(causal_conv1d(bm_raw, p["conv_b"]).float())
    cm_f = F.silu(causal_conv1d(cm_raw, p["conv_c"]).float())
    xin, bm, cm = (t.to(x.dtype) for t in (xin_f, bm_f, cm_f))
    nh, hd = cfg.ssm_num_heads, cfg.ssm_head_dim
    a = _decay_rates(p)
    y = kops.ssd(xin.reshape(b, s, nh, hd), dt, a, bm, cm, p["d_skip"].float())
    out = _gate_out(cfg, p, x, y.reshape(b, s, cfg.d_inner), z)
    if not want_cache:
        return out
    # run eagerly, the block would hold these to its end, beside the state's
    # (B, S, H, P) float32 product
    del h, z, xin, bm, cm, cm_f, y
    return out, _ssd_state_cache(cfg, dt, a, xin_f, bm_f, xin_raw, bm_raw, cm_raw, lengths)


def _cols(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Columns ``[lo, hi)`` of ``t``'s last dim (``t`` itself when whole)."""
    return t if (lo, hi) == (0, t.shape[-1]) else t[..., lo:hi]


def ssd_block_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                     cache: Dict, ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """x (B, 1, D). cache: {"state": (B, H, P, N) float32, "conv_x":
    (B, W-1, Di), "conv_b"/"conv_c": (B, W-1, N)}, updated in place. Under
    a serving ``ctx`` over a model axis: this rank's heads (its block of
    the state; its columns of the whole ``conv_x`` tail, which is gathered
    back), B and C whole, the gated norm's mean square and the output
    projection summed over the model group."""
    ctx = ctx or ShardCtx()
    full = ssd_block_params(cfg)
    if ctx.tp and not _split(p, full, ("wz", "wx", "conv_x", "wdt", "w_out")):
        return ssd_block_decode(cfg, _whole_params(p, full, ctx), x, cache)
    b = x.shape[0]
    di, nh, hd = cfg.d_inner, cfg.ssm_num_heads, cfg.ssm_head_dim
    h_lo, h_hi = ctx.span(nh)
    q = dict(p, **{k: ctx.part(p[k], 0, nh) for k in ("dt_bias", "a_log", "d_skip")})
    h = rms_norm(x, p["ln"])
    z, xin, bm, cm, dt = _ssd_pre(cfg, q, h)
    xin, cx = causal_conv1d(xin, p["conv_x"], state=_cols(cache["conv_x"], h_lo * hd,
                                                          h_hi * hd))
    bm, cb = causal_conv1d(bm, p["conv_b"], state=cache["conv_b"])
    cm, cc = causal_conv1d(cm, p["conv_c"], state=cache["conv_c"])
    xin = F.silu(xin.float()).to(x.dtype)
    bm = F.silu(bm.float())[:, 0]                                    # (B, N)
    cm = F.silu(cm.float())[:, 0]
    hl = h_hi - h_lo
    xh = xin.reshape(b, hl, hd).float()                              # (B, H, P)
    dtv = dt[:, 0]                                                   # (B, H)
    decay = torch.exp(dtv * _decay_rates(q)[None, :])
    upd = (dtv[..., None] * xh)[..., None] * bm[:, None, None, :]
    state = decay[..., None, None] * cache["state"] + upd
    y = torch.einsum("bhpn,bn->bhp", state, cm)
    y = y + q["d_skip"].float()[None, :, None] * xh
    out = _gate_out(cfg, p, x, y.reshape(b, 1, hl * hd).to(x.dtype), z, ctx)
    cache["state"].copy_(state)
    cache["conv_x"].copy_(ctx.whole_dim(cx, 2, di))
    cache["conv_b"].copy_(cb)
    cache["conv_c"].copy_(cc)
    return out


def ssd_cache_spec(cfg: ModelConfig, batch: int, dtype: torch.dtype) -> Dict:
    """Per-layer decode state: {name: (shape, axes, dtype)}; the SSD state
    stays float32, the conv tails are in the model dtype."""
    wc = cfg.ssm_conv_width
    return {
        "state": ((batch, cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state),
                  ("batch", "ssm_heads", None, "ssm_state"), torch.float32),
        "conv_x": ((batch, wc - 1, cfg.d_inner), ("batch", None, "ssm_inner"), dtype),
        "conv_b": ((batch, wc - 1, cfg.ssm_state), ("batch", None, None), dtype),
        "conv_c": ((batch, wc - 1, cfg.ssm_state), ("batch", None, None), dtype),
    }


# ===========================================================================
# RG-LRU (recurrentgemma) block
# ===========================================================================

LRU_C = 8.0


def rglru_block_params(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "ln": ((d,), (None,), "ones"),
        "wx": ((d, w), ("embed", "lru"), "normal"),
        "wy": ((d, w), ("embed", "lru"), "normal"),
        "conv": ((4, w), ("conv", "lru"), "normal"),
        "w_r": ((w, w), (None, "lru"), "normal"),
        "w_i": ((w, w), (None, "lru"), "normal"),
        "b_r": ((w,), (None,), "zeros"),
        "b_i": ((w,), (None,), "zeros"),
        "a_log": ((w,), (None,), "ssm_a"),
        "w_out": ((w, d), ("lru", "embed_out"), "normal"),
    }


def _lru_decay(p: Dict) -> torch.Tensor:
    """Per-channel ``-LRU_C * softplus(a_log)`` in float32; softplus as
    ``logaddexp(x, 0)``, the reference's form (``F.softplus`` switches to x
    above 20)."""
    a_log = p["a_log"].float()
    return -LRU_C * torch.logaddexp(a_log, torch.zeros_like(a_log))


def _gate_pre(p: Dict, xb: torch.Tensor):
    """The gates' pre-activations, each bias added in the model dtype."""
    return torch.matmul(xb, p["w_r"]) + p["b_r"], torch.matmul(xb, p["w_i"]) + p["b_i"]


def _lru_gates(p: Dict, xb: torch.Tensor):
    """``(a, gate)`` in float32 for the conv output ``xb``."""
    return lru_gates_torch(*_gate_pre(p, xb), _lru_decay(p))


def _rglru_block_tp(cfg: ModelConfig, p: Dict, x: torch.Tensor, ctx: ShardCtx,
                    lengths: Optional[torch.Tensor] = None, want_cache: bool = False):
    """:func:`rglru_block_apply` over a model axis: each rank its block of
    the channels (``wx``, ``wy``, ``conv``, ``w_r``, ``w_i``, ``w_out``
    split over ``lru``; ``b_r``, ``b_i`` and ``a_log`` sliced from their
    whole tensors). A channel's gates read every channel of the conv
    output, which is all-gathered over the model group. With
    ``want_cache`` the decode state whole (the cache does not split the
    channels), gathered over the model group."""
    full = rglru_block_params(cfg)
    if not _split(p, full, ("wx", "wy", "conv", "w_r", "w_i", "w_out")):
        return _whole_block(rglru_block_apply, cfg, p, x, full, ctx,
                            **({"lengths": lengths, "want_cache": True} if want_cache else {}))
    w = cfg.lru_width or cfg.d_model
    h = ctx.enter(rms_norm(x, ctx.gain(p["ln"])))
    xb_raw = torch.matmul(h, p["wx"])
    xb = causal_conv1d(xb_raw, p["conv"])
    y_pre = torch.matmul(h, p["wy"])
    q = dict(p, **{k: ctx.part(p[k], 0, w) for k in ("b_r", "b_i", "a_log")})
    r_pre, i_pre = _gate_pre(q, comm.AllGatherDim.apply(xb, 2, ctx.model_group))
    y, h_state = kops.rglru(xb, r_pre, i_pre, y_pre, _lru_decay(q), lengths)
    out = x + ctx.leave(torch.matmul(y, p["w_out"]))
    if not want_cache:
        return out
    if lengths is None:
        lengths = torch.full((h.shape[0],), h.shape[1], dtype=torch.int32, device=x.device)
    return out, {"h": ctx.whole_dim(h_state, 1, w),
                 "conv": ctx.whole_dim(_conv_tail(xb_raw, p["conv"].shape[0], lengths), 2, w)}


def rglru_block_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
                      lengths: Optional[torch.Tensor] = None,
                      want_cache: bool = False, ctx: Optional[ShardCtx] = None):
    """Full-sequence forward. Returns ``x_out``, or with ``want_cache``
    ``(x_out, cache)`` where cache is the decode state after a per-row
    prompt of ``lengths`` tokens: {"h": (B, W) float32 at each row's
    ``lengths - 1``, "conv": the last 3 raw conv inputs}. The gates, the
    recurrence and the product with the gelu'd y branch run in
    ``kernels.ops.rglru`` (one kernel on the card; where autograd records
    the call, its training op, which forms no decode state). Over a model
    axis (``ctx.tp``): :func:`_rglru_block_tp`."""
    if ctx is not None and ctx.tp:
        return _rglru_block_tp(cfg, p, x, ctx, lengths, want_cache)
    h = rms_norm(x, p["ln"])
    xb_raw = torch.matmul(h, p["wx"])
    y_pre = torch.matmul(h, p["wy"])
    xb = causal_conv1d(xb_raw, p["conv"])
    r_pre, i_pre = _gate_pre(p, xb)
    y, h_state = kops.rglru(xb, r_pre, i_pre, y_pre, _lru_decay(p),
                            lengths)
    out = x + torch.matmul(y, p["w_out"])
    if not want_cache:
        return out
    if lengths is None:
        lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                             device=x.device)
    return out, {"h": h_state, "conv": _conv_tail(xb_raw, p["conv"].shape[0], lengths)}


def rglru_block_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                       cache: Dict, ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """x (B, 1, D). cache: {"h": (B, W) float32, "conv": (B, 3, W)},
    updated in place. One step, in plain PyTorch. Under a serving ``ctx``
    over a model axis: this rank's channels (the gates read every channel
    of the conv output, gathered), the output projection summed over the
    model group, and the whole state gathered back into the cache."""
    ctx = ctx or ShardCtx()
    full = rglru_block_params(cfg)
    if ctx.tp and not _split(p, full, ("wx", "wy", "conv", "w_r", "w_i", "w_out")):
        return rglru_block_decode(cfg, _whole_params(p, full, ctx), x, cache)
    w = cfg.lru_width or cfg.d_model
    lo, hi = ctx.span(w)
    q = dict(p, **{k: ctx.part(p[k], 0, w) for k in ("b_r", "b_i", "a_log")})
    hn = rms_norm(x, p["ln"])
    xb = torch.matmul(hn, p["wx"])
    yb = F.gelu(torch.matmul(hn, p["wy"]).float(), approximate="tanh")
    xb, conv_state = causal_conv1d(xb, p["conv"], state=_cols(cache["conv"], lo, hi))
    a, gate = _lru_gates(q, ctx.whole_dim(xb, 2, w))
    hstate = a[:, 0] * _cols(cache["h"], lo, hi) + (gate * xb.float())[:, 0]
    y = (hstate[:, None, :] * yb).to(x.dtype)
    out = x + ctx.leave(torch.matmul(y, p["w_out"]))
    cache["h"].copy_(ctx.whole_dim(hstate, 1, w))
    cache["conv"].copy_(ctx.whole_dim(conv_state, 2, w))
    return out


def rglru_cache_spec(cfg: ModelConfig, batch: int, dtype: torch.dtype) -> Dict:
    """Per-layer decode state: {name: (shape, axes, dtype)}; the state
    stays float32, the conv tail is in the model dtype."""
    w = cfg.lru_width or cfg.d_model
    return {
        "h": ((batch, w), ("batch", "lru"), torch.float32),
        "conv": ((batch, 3, w), ("batch", None, "lru"), dtype),
    }
