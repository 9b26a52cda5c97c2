"""Attention forward paths (port of ``repro/models/attention.py``).

One logical op, three physical operators, chosen by where the tensors are:

* CUDA tensors: the flash-attention kernel through ``kernels.ops``, with K/V
  in kv-head form (the GQA expansion is never materialized);
* CPU, short sequences: ``_einsum`` (the reference's CPU operator);
* CPU, long sequences: the forward of ``_blocked`` (online softmax over KV
  chunks). Its backward waits for the training slice.

plus the decode path: one query against a dense (possibly rotating) cache,
or against a paged flat slot stack through per-row page tables.

The cache writes update the slot stacks in place (``index_copy_``): PyTorch's
counterpart of the reference's donated, aliased decode step. JAX clamps
out-of-range gather indices and drops out-of-range scatters; PyTorch raises
on both, so every index here is clamped or masked explicitly, and a dropped
write never changes a slot.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops

BLOCKED_THRESHOLD = 4096  # beyond this seq, the CPU path uses _blocked
KV_CHUNK = 1024
NEG_INF = -1e30


def attention(
    q: torch.Tensor,     # (B, Sq, Hq, D)
    k: torch.Tensor,     # (B, Sk, Hkv, D) — kv-head form
    v: torch.Tensor,     # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,   # absolute position of q[0] relative to k[0]
) -> torch.Tensor:
    sq, hq = q.shape[1], q.shape[2]
    sk, hkv = k.shape[1], k.shape[2]
    if q.device.type == "cuda":
        out = kops.attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=causal, window=window,
            q_offset=q_offset)
        return out.transpose(1, 2)
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    big = max(sq, sk) >= BLOCKED_THRESHOLD
    # windowed attention beyond its window always prefers the blocked
    # operator: the einsum operator would materialize the full S^2 scores
    if window and max(sq, sk) > window:
        big = True
    if big and sq > 1:
        return _blocked(q, k, v, causal, window, q_offset)
    return _einsum(q, k, v, causal=causal, window=window, q_offset=q_offset)


def _mask(sq, sk, q_offset, causal, window, device):
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def _einsum(q, k, v, *, causal, window, q_offset):
    d = q.shape[-1]
    qf = q.float() * (d ** -0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    m = _mask(q.shape[1], k.shape[1], q_offset, causal, window, q.device)
    s = torch.where(m[None, None], s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def _blocked(q, k, v, causal, window, q_offset):
    """Online softmax over KV chunks: flash semantics in plain ops."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    chunk = min(KV_CHUNK, sk)
    n_chunks = -(-sk // chunk)
    qf = q.float() * (d ** -0.5)
    qpos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, sq, h), NEG_INF, device=q.device)
    l_sum = torch.zeros((b, sq, h), device=q.device)
    acc = torch.zeros((b, sq, h, d), device=q.device)
    for ci in range(n_chunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk].float()
        vb = v[:, ci * chunk:(ci + 1) * chunk].float()
        kpos = ci * chunk + torch.arange(kb.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kb)
        msk = torch.ones((sq, kb.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            msk &= kpos[None, :] <= qpos[:, None]
        if window:
            msk &= kpos[None, :] > (qpos[:, None] - window)
        msk = msk[None, :, None, :]
        s = torch.where(msk, s, torch.full((), NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(msk, torch.exp(s - m_new[..., None]), torch.zeros((), device=q.device))
        alpha = torch.exp(m - m_new)
        l_sum = alpha * l_sum + p.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.einsum("bqhk,bkhd->bqhd", p, vb)
        m = m_new
    l_safe = torch.where(l_sum == 0, torch.ones((), device=q.device), l_sum)
    return (acc / l_safe[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# decode: one query against a (possibly rotating) cache
# ---------------------------------------------------------------------------


def decode_attention(
    q: torch.Tensor,        # (B, 1, Hq, D)
    k_cache: torch.Tensor,  # (B, Sc, Hq, D) — GQA already expanded
    v_cache: torch.Tensor,
    pos: torch.Tensor,      # () or (B,) absolute position of the new token
    *,
    window: int = 0,        # rotating cache iff window > 0 (Sc == window)
) -> torch.Tensor:
    d = q.shape[-1]
    sc = k_cache.shape[1]
    qf = (q.float() * (d ** -0.5))[:, 0]
    s = torch.einsum("bhd,bkhd->bhk", qf, k_cache.float())
    slots = torch.arange(sc, device=q.device)[None, :]         # (1, Sc)
    pb = pos.reshape(-1, 1).long()                             # (B, 1) or (1, 1)
    if window:
        # rotating cache: slot i holds absolute position
        # p_i = pos - ((pos - i) mod Sc); valid iff 0 <= p_i <= pos
        p_i = pb - torch.remainder(pb - slots, sc)
        valid = (p_i >= 0) & (p_i <= pb)
    else:
        valid = slots <= pb
    s = torch.where(valid[:, None, :], s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", p, v_cache.float())
    return o[:, None].to(q.dtype)


def paged_slots(tables: torch.Tensor, lslots: torch.Tensor,
                page: int) -> torch.Tensor:
    """Physical slot per logical slot through a page table:
    ``table[lslot // page] * page + lslot % page``.

    ``tables``: (B, max_pages) int32; unallocated entries hold the sentinel
    ``n_pages`` and map past the slot stack. ``lslots``: (B,) or (B, S).
    Returns int64 physical slots of the same shape."""
    lslots = lslots.long()
    lp = torch.clamp(torch.div(lslots, page, rounding_mode="floor"), 0,
                     tables.shape[1] - 1)
    idx = lp if lp.dim() > 1 else lp[:, None]
    entry = torch.gather(tables.long(), 1, idx)
    if lp.dim() == 1:
        entry = entry[:, 0]
    return entry * page + torch.remainder(lslots, page)


def paged_gather_kv(
    k_cache: torch.Tensor,  # (n_slots, Hkv, D) — flat per-arena slot stack
    v_cache: torch.Tensor,
    tables: torch.Tensor,   # (B, max_pages) int32 page table per row
    page: int,
    sc: int,                # logical cache slots per row
    pos: Optional[torch.Tensor] = None,  # per-row decode position
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather each row's logical cache view ``(B, sc, Hkv, D)`` out of the
    shared slot stack. With ``pos``, slots beyond each row's committed
    extent ``min(pos + 1, sc)`` are pinned to slot 0 and zeroed."""
    b = tables.shape[0]
    i = torch.arange(sc, device=tables.device)
    phys = paged_slots(tables, i.expand(b, sc), page)
    phys = torch.clamp(phys, max=k_cache.shape[0] - 1)
    if pos is None:
        return k_cache[phys], v_cache[phys]
    posb = pos.reshape(-1).long().expand(b)
    committed = i[None, :] < torch.clamp(posb + 1, max=sc)[:, None]   # (B, sc)
    phys = torch.where(committed, phys, torch.zeros((), dtype=phys.dtype,
                                                    device=phys.device))
    keep = committed[..., None, None]
    zero = torch.zeros((), dtype=k_cache.dtype, device=k_cache.device)
    return torch.where(keep, k_cache[phys], zero), torch.where(keep, v_cache[phys], zero)


def _write_kept(dst: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
                src: torch.Tensor) -> None:
    """``dst[idx[i]] = src[i]`` in place for every ``i`` with ``keep[i]`` and
    ``idx[i]`` in range; every other write is dropped (the reference's
    ``mode="drop"`` scatter). No host sync: a dropped write is redirected to
    repeat the first kept write (same slot, same value), or — when nothing
    is kept — to re-store the value its target already holds, so a dropped
    write changes no slot."""
    n = dst.shape[0]
    keep = keep & (idx >= 0) & (idx < n)
    idx_c = torch.clamp(idx, 0, n - 1)
    # (1,)-shaped picks via index_select: indexing with a 0-d tensor would
    # read it back to the host (a device sync per call)
    first = torch.argmax(keep.to(torch.int8)).reshape(1)   # first kept row, else 0
    bcast = (-1, *([1] * (src.dim() - 1)))
    any_kept = keep.index_select(0, first).view(bcast)
    fill_idx = idx_c.index_select(0, first)
    fill_val = torch.where(any_kept, src.index_select(0, first),
                           dst.index_select(0, fill_idx))
    tgt = torch.where(keep, idx_c, fill_idx)
    val = torch.where(keep.view(bcast), src, fill_val)
    dst.index_copy_(0, tgt, val)


def paged_cache_write(
    k_cache: torch.Tensor, v_cache: torch.Tensor,  # (n_slots, Hkv, D)
    k_new: torch.Tensor, v_new: torch.Tensor,      # (B, 1, Hkv, D)
    pos: torch.Tensor, tables: torch.Tensor, page: int, sc: int,
    *, window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter each row's new K/V into its page-mapped physical slot, in
    place. Rotating caches (window > 0) wrap within the row's own pages
    (``pos mod sc``); non-rotating writes beyond capacity — and writes from
    rows whose page table is unallocated (free rows) — are dropped."""
    b = k_new.shape[0]
    posb = pos.reshape(-1).long().expand(b)
    lslot = torch.remainder(posb, sc) if window else posb
    phys = paged_slots(tables, lslot, page)
    keep = torch.ones_like(posb, dtype=torch.bool) if window else posb < sc
    _write_kept(k_cache, phys, keep, k_new[:, 0].to(k_cache.dtype))
    _write_kept(v_cache, phys, keep, v_new[:, 0].to(v_cache.dtype))
    return k_cache, v_cache


def cache_write(
    k_cache: torch.Tensor, v_cache: torch.Tensor,  # (B, Sc, Hkv, D)
    k_new: torch.Tensor, v_new: torch.Tensor,      # (B, 1, Hkv, D)
    pos: torch.Tensor, *, window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense cache write, in place. ``pos`` scalar: one shared slot, clamped
    into ``[0, Sc)`` as the reference's dynamic-update-slice clamps it.
    ``pos`` (B,): each row writes its own slot; out-of-capacity rows drop."""
    b, sc = k_cache.shape[0], k_cache.shape[1]
    if pos.dim():
        posl = pos.long()
        slot = torch.remainder(posl, sc) if window else posl
        keep = (slot >= 0) & (slot < sc)
        flat = torch.arange(b, device=slot.device) * sc + slot
        _write_kept(k_cache.view(b * sc, *k_cache.shape[2:]), flat, keep,
                    k_new[:, 0].to(k_cache.dtype))
        _write_kept(v_cache.view(b * sc, *v_cache.shape[2:]), flat, keep,
                    v_new[:, 0].to(v_cache.dtype))
        return k_cache, v_cache
    slot = torch.remainder(pos.long(), sc) if window else pos.long()
    slot = torch.clamp(slot, 0, sc - 1).reshape(1)
    k_cache.index_copy_(1, slot, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v_new.to(v_cache.dtype))
    return k_cache, v_cache
