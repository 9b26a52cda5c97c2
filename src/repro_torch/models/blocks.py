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
    does not split, whole on every rank."""
    up, down = ("wi", "wo_mlp") if cfg.family == "audio" else ("wg", "wd")
    if p[up].shape[1] != cfg.d_ff:
        return ctx.leave(_dense_ffn(cfg, p, ctx.enter(h)))
    q = dict(p, **{down: ctx.rep_param(p[down], 1, cfg.d_model)})
    return ctx.rep_out(_dense_ffn(cfg, q, ctx.rep_in(h)))


def _kv_heads(ctx: ShardCtx, w: torch.Tensor, lo: int, hi: int, kv: int) -> torch.Tensor:
    """The kv heads ``[lo, hi)`` of ``wk``/``wv``: the rank's block where the
    rules split the kv heads (then exactly these), else a slice of the
    whole tensor."""
    if w.shape[1] != kv:
        return w
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
                  *, causal: bool, window: int) -> torch.Tensor:
    """Attention over a model axis, queries from ``h`` and K/V from
    ``kv_in`` (``h`` itself, or the encoder's output), both in the residual
    stream's form; returns the output projection in that form. ``positions``
    (the whole sequence's) rope the queries and keys, None for none.

    Heads split over the ranks: each rank's q heads and the kv heads they
    read, row-parallel ``wo``. Heads that do not split, under sequence
    parallelism: this rank's query positions against the gathered K/V at
    ``q_offset`` (the reference's SP attention), ``wo`` whole. Otherwise
    the attention whole on every rank."""
    wq, wk, wv, wo = (p[n] for n in names)
    hq, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    g = hq // kv
    if wq.shape[1] != hq:
        hf = ctx.enter(h)
        kf = hf if kv_in is h else ctx.enter(kv_in)
        lo, hi = ctx.span(hq)
        k_lo, k_hi = lo // g, (hi - 1) // g + 1
        q = _proj_heads(hf, wq)
        k = _proj_heads(kf, _kv_heads(ctx, wk, k_lo, k_hi, kv))
        v = _proj_heads(kf, _kv_heads(ctx, wv, k_lo, k_hi, kv))
        if positions is not None:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        k, v = _gqa_local(k, v, lo, hi, g, k_lo)
        o = ATT.attention(q, k, v, causal=causal, window=window)
        return ctx.leave(_out_proj(o, wo))
    if ctx.sp:
        kf = ctx.enter(kv_in)
        off = ctx.seq_offset(h.shape[1])
        q = _proj_heads(h, ctx.whole(wq))
        k = _proj_heads(kf, ctx.whole(wk))
        v = _proj_heads(kf, ctx.whole(wv))
        if positions is not None:
            q = rope(q, positions[off:off + h.shape[1]], cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        o = ATT.attention(q, k, v, causal=causal, window=window, q_offset=off)
        return _out_proj(o, ctx.joined(wo, 2, d))
    q = _proj_heads(h, wq)
    k = _proj_heads(kv_in, wk)
    v = _proj_heads(kv_in, wv)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = ATT.attention(q, k, v, causal=causal, window=window)
    return _out_proj(o, ctx.rep_param(wo, 2, d))


def _attn_block_tp(cfg: ModelConfig, p: Dict, x: torch.Tensor, positions: torch.Tensor,
                   ctx: ShardCtx, *, causal: bool, window: int,
                   enc_out: Optional[torch.Tensor]):
    """:func:`attn_block_apply` over a model axis; ``x`` is the residual
    stream (under sequence parallelism this rank's shard of it) and
    ``positions`` the whole sequence's."""
    h = rms_norm(x, ctx.gain(p["ln1"]))
    x = x + _attention_tp(cfg, p, h, h, positions, ctx, ("wq", "wk", "wv", "wo"),
                          causal=causal, window=window)
    if enc_out is not None:
        h = rms_norm(x, ctx.gain(p["xln"]))
        x = x + _attention_tp(cfg, p, h, enc_out, None, ctx, ("xwq", "xwk", "xwv", "xwo"),
                              causal=False, window=0)
    f, aux = _ffn(cfg, p, rms_norm(x, ctx.gain(p["ln2"])), ctx)
    return x + f, aux, {}


def _cross(p: Dict, x: torch.Tensor, kx: torch.Tensor, vx: torch.Tensor) -> torch.Tensor:
    """The residual stream after cross attention: queries from ``x`` (no
    rope) over the encoder's K/V ``(B, Senc, Kv, Dh)`` in kv-head form,
    every key seen (``causal=False``): on a CUDA tensor the flash kernel, or
    at one query row (a decode tick) ``flash_decode``, which reads the K/V
    in place."""
    qx = _proj_heads(rms_norm(x, p["xln"]), p["xwq"])
    ox = ATT.attention(qx, kx, vx, causal=False)
    return x + _out_proj(ox, p["xwo"])


def attn_block_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                     positions: torch.Tensor, *, causal: bool = True,
                     window: int = 0, ctx: Optional[ShardCtx] = None,
                     enc_out: Optional[torch.Tensor] = None):
    """Full-sequence forward. Returns ``(x_out, aux, {"k", "v"})``: the
    FFN's auxiliary loss (the MoE load-balance loss, else 0) and the rope'd
    K/V in kv-head cache-row form ``(B, S, Kv, Dh)`` for the prefill→decode
    handoff. With ``enc_out`` (an encoder-decoder's decoder block) cross
    attention over it follows the self-attention. Over a model axis
    (``ctx.tp``; a train step) no K/V are returned."""
    if ctx is not None and ctx.tp:
        return _attn_block_tp(cfg, p, x, positions, ctx, causal=causal, window=window,
                              enc_out=enc_out)
    h = rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h, positions)
    o = ATT.attention(q, k, v, causal=causal, window=window)
    x = x + _out_proj(o, p["wo"])
    if enc_out is not None:
        x = _cross(p, x, _proj_heads(enc_out, p["xwk"]), _proj_heads(enc_out, p["xwv"]))
    f, aux = _ffn(cfg, p, rms_norm(x, p["ln2"]), ctx)
    return x + f, aux, {"k": k, "v": v}


def attn_block_decode(
    cfg: ModelConfig, p: Dict, x: torch.Tensor, cache: Dict, pos: torch.Tensor,
    *, window: int = 0, tables: Optional[torch.Tensor] = None, page: int = 0,
    sc: int = 0, decode_kernel: str = "gather",
    enc_out_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
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
    where the cache holds them."""
    h = rms_norm(x, p["ln1"])
    rope_pos = pos[None] if pos.dim() == 0 else pos[:, None]
    q, k, v = _qkv(cfg, p, h, rope_pos)
    g = cfg.q_per_kv
    if tables is not None:
        kc, vc = ATT.paged_cache_write(cache["k"], cache["v"], k, v, pos,
                                       tables, page, sc, window=window)
        if decode_kernel == "paged":
            # committed-slot mask == decode validity mask for both dense and
            # rotating rows (kernels/paged_attention.py), so the fused op
            # needs pos and sc but not the window
            posb = pos.reshape(-1).expand(x.shape[0]).contiguous()
            o = kops.paged_attention(q.contiguous(), kc, vc, tables, posb,
                                     page=page, sc=sc)
        elif decode_kernel == "ref":
            o = kref.paged_decode_ref(q, kc, vc, tables, pos, page=page, sc=sc,
                                      window=window)
        elif decode_kernel == "gather":
            ke, ve = ATT.paged_gather_kv(kc, vc, tables, page, sc, pos=pos)
            if g > 1:
                ke = ke.repeat_interleave(g, dim=2)
                ve = ve.repeat_interleave(g, dim=2)
            o = ATT.decode_attention(q, ke, ve, pos, window=window)
        else:
            raise ValueError(f"decode_kernel must be one of {DECODE_KERNELS}, "
                             f"got {decode_kernel!r}")
    else:
        kc, vc = ATT.cache_write(cache["k"], cache["v"], k, v, pos, window=window)
        ke, ve = kc, vc
        if g > 1:
            ke = ke.repeat_interleave(g, dim=2)
            ve = ve.repeat_interleave(g, dim=2)
        o = ATT.decode_attention(q, ke, ve, pos, window=window)
    x = x + _out_proj(o, p["wo"])
    if enc_out_kv is not None:
        x = _cross(p, x, *enc_out_kv)
    f, _aux = _ffn(cfg, p, rms_norm(x, p["ln2"]))       # decode drops aux
    return x + f


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
              z: torch.Tensor) -> torch.Tensor:
    """Gated RMSNorm of the SSD output, the output projection and the
    residual."""
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["gate_ln"])
    return x + torch.matmul(y, p["w_out"])


def _whole_block(fn, cfg: ModelConfig, p: Dict, x: torch.Tensor, full: Dict,
                 ctx: ShardCtx) -> torch.Tensor:
    """``fn(cfg, p, x)`` run whole on every model rank, for a block whose
    split dims do not divide the model axis: each parameter the rules split
    gathered, the residual stream's sequence shards gathered under
    sequence parallelism."""
    q = {}
    for k, t in p.items():
        dims = [i for i, (a, n) in enumerate(zip(t.shape, full[k][0])) if a != n]
        q[k] = ctx.rep_param(t, dims[0], full[k][0][dims[0]]) if dims else t
    return ctx.rep_out(fn(cfg, q, ctx.rep_in(x)))


def _split(p: Dict, full: Dict, names: Tuple[str, ...]) -> bool:
    """Whether the rules split every one of ``names`` over the model axis."""
    return all(tuple(p[k].shape) != full[k][0] for k in names)


def _ssd_block_tp(cfg: ModelConfig, p: Dict, x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """:func:`ssd_block_apply` (no cache) over a model axis: each rank its
    block of the heads (``wz``, ``wx``, ``conv_x``, ``wdt``, ``w_out`` split
    over ``ssm_inner`` / ``ssm_heads``; ``dt_bias``, ``a_log``, ``d_skip``
    and ``gate_ln`` sliced from their whole tensors), B and C whole on every
    rank, the gated RMS norm over the whole inner width."""
    full = ssd_block_params(cfg)
    if not _split(p, full, ("wz", "wx", "conv_x", "wdt", "w_out")):
        return _whole_block(ssd_block_apply, cfg, p, x, full, ctx)
    di, nh, hd = cfg.d_inner, cfg.ssm_num_heads, cfg.ssm_head_dim
    h = ctx.enter(rms_norm(x, ctx.gain(p["ln"])))
    b, s, _d = h.shape
    z = torch.matmul(h, p["wz"])
    xin_raw = torch.matmul(h, p["wx"])
    bm_raw = torch.matmul(h, ctx.whole(p["wb"]))
    cm_raw = torch.matmul(h, ctx.whole(p["wc"]))
    dt = F.softplus(torch.matmul(h, p["wdt"]).float() + ctx.part(p["dt_bias"], 0, nh).float())
    xin = F.silu(causal_conv1d(xin_raw, p["conv_x"]).float()).to(x.dtype)
    bm = F.silu(causal_conv1d(bm_raw, ctx.whole(p["conv_b"])).float()).to(x.dtype)
    cm = F.silu(causal_conv1d(cm_raw, ctx.whole(p["conv_c"])).float()).to(x.dtype)
    a = -torch.exp(ctx.part(p["a_log"], 0, nh).float())
    hl = dt.shape[-1]
    y = kops.ssd(xin.reshape(b, s, hl, hd), dt, a, bm, cm,
                 ctx.part(p["d_skip"], 0, nh).float()).reshape(b, s, hl * hd)
    y = rms_norm_sharded(y * F.silu(z.float()).to(x.dtype), ctx.part(p["gate_ln"], 0, di),
                         di, ctx.model_group)
    return x + ctx.leave(torch.matmul(y, p["w_out"]))


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
    axis (``ctx.tp``, a train step): :func:`_ssd_block_tp`."""
    if ctx is not None and ctx.tp:
        return _ssd_block_tp(cfg, p, x, ctx)
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
    # (B, S, H, P) float32 product below
    del h, z, xin, bm, cm, cm_f, y
    # Final SSM state at per-row prompt length T, in closed form:
    #   state_T = sum_{t<T} exp(sum_{u=t+1..T-1} dt_u a) dt_t x_t (x) b_t
    # via log-space prefix sums: no per-position states are held.
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    rows = torch.arange(b, device=x.device)
    cum = torch.cumsum(dt * a[None, None, :], dim=1)                # (B, S, H), <= 0
    cum_t = cum[rows, lengths.long() - 1][:, None, :]                 # (B, 1, H)
    tmask = torch.arange(s, device=x.device)[None, :] < lengths[:, None]
    w = torch.exp(torch.clamp(cum_t - cum, max=0.0)) * tmask[..., None]
    wx = (w * dt)[..., None] * xin_f.reshape(b, s, nh, hd)           # (B, S, H, P)
    # one (H P, S) @ (S, N) product per row: B is shared by every head, so
    # it is never expanded to (B, H, S, N)
    state = torch.matmul(wx.reshape(b, s, nh * hd).transpose(1, 2),
                         bm_f).reshape(b, nh, hd, -1)                # (B, H, P, N)
    wc = cfg.ssm_conv_width
    cache = {
        "state": state,
        "conv_x": _conv_tail(xin_raw, wc, lengths),
        "conv_b": _conv_tail(bm_raw, wc, lengths),
        "conv_c": _conv_tail(cm_raw, wc, lengths),
    }
    return out, cache


def ssd_block_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                     cache: Dict) -> torch.Tensor:
    """x (B, 1, D). cache: {"state": (B, H, P, N) float32, "conv_x":
    (B, W-1, Di), "conv_b"/"conv_c": (B, W-1, N)}, updated in place."""
    b = x.shape[0]
    h = rms_norm(x, p["ln"])
    z, xin, bm, cm, dt = _ssd_pre(cfg, p, h)
    xin, cx = causal_conv1d(xin, p["conv_x"], state=cache["conv_x"])
    bm, cb = causal_conv1d(bm, p["conv_b"], state=cache["conv_b"])
    cm, cc = causal_conv1d(cm, p["conv_c"], state=cache["conv_c"])
    xin = F.silu(xin.float()).to(x.dtype)
    bm = F.silu(bm.float())[:, 0]                                    # (B, N)
    cm = F.silu(cm.float())[:, 0]
    nh, hd = cfg.ssm_num_heads, cfg.ssm_head_dim
    xh = xin.reshape(b, nh, hd).float()                              # (B, H, P)
    dtv = dt[:, 0]                                                   # (B, H)
    decay = torch.exp(dtv * _decay_rates(p)[None, :])
    upd = (dtv[..., None] * xh)[..., None] * bm[:, None, None, :]
    state = decay[..., None, None] * cache["state"] + upd
    y = torch.einsum("bhpn,bn->bhp", state, cm)
    y = y + p["d_skip"].float()[None, :, None] * xh
    out = _gate_out(cfg, p, x, y.reshape(b, 1, cfg.d_inner).to(x.dtype), z)
    cache["state"].copy_(state)
    cache["conv_x"].copy_(cx)
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


def _rglru_block_tp(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                    ctx: ShardCtx) -> torch.Tensor:
    """:func:`rglru_block_apply` (no cache) over a model axis: each rank its
    block of the channels (``wx``, ``wy``, ``conv``, ``w_r``, ``w_i``,
    ``w_out`` split over ``lru``; ``b_r``, ``b_i`` and ``a_log`` sliced from
    their whole tensors). A channel's gates read every channel of the conv
    output, which is all-gathered over the model group."""
    full = rglru_block_params(cfg)
    if not _split(p, full, ("wx", "wy", "conv", "w_r", "w_i", "w_out")):
        return _whole_block(rglru_block_apply, cfg, p, x, full, ctx)
    w = cfg.lru_width or cfg.d_model
    h = ctx.enter(rms_norm(x, ctx.gain(p["ln"])))
    xb = causal_conv1d(torch.matmul(h, p["wx"]), p["conv"])
    y_pre = torch.matmul(h, p["wy"])
    q = dict(p, **{k: ctx.part(p[k], 0, w) for k in ("b_r", "b_i", "a_log")})
    r_pre, i_pre = _gate_pre(q, comm.AllGatherDim.apply(xb, 2, ctx.model_group))
    y, _h = kops.rglru(xb, r_pre, i_pre, y_pre, _lru_decay(q))
    return x + ctx.leave(torch.matmul(y, p["w_out"]))


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
    axis (``ctx.tp``, a train step): :func:`_rglru_block_tp`."""
    if ctx is not None and ctx.tp:
        return _rglru_block_tp(cfg, p, x, ctx)
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
                       cache: Dict) -> torch.Tensor:
    """x (B, 1, D). cache: {"h": (B, W) float32, "conv": (B, 3, W)},
    updated in place. One step, in plain PyTorch."""
    hn = rms_norm(x, p["ln"])
    xb = torch.matmul(hn, p["wx"])
    yb = F.gelu(torch.matmul(hn, p["wy"]).float(), approximate="tanh")
    xb, conv_state = causal_conv1d(xb, p["conv"], state=cache["conv"])
    a, gate = _lru_gates(p, xb)
    hstate = a[:, 0] * cache["h"] + (gate * xb.float())[:, 0]
    y = (hstate[:, None, :] * yb).to(x.dtype)
    out = x + torch.matmul(y, p["w_out"])
    cache["h"].copy_(hstate)
    cache["conv"].copy_(conv_state)
    return out


def rglru_cache_spec(cfg: ModelConfig, batch: int, dtype: torch.dtype) -> Dict:
    """Per-layer decode state: {name: (shape, axes, dtype)}; the state
    stays float32, the conv tail is in the model dtype."""
    w = cfg.lru_width or cfg.d_model
    return {
        "h": ((batch, w), ("batch", "lru"), torch.float32),
        "conv": ((batch, 3, w), ("batch", None, "lru"), dtype),
    }
