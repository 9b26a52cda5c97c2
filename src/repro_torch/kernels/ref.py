"""Plain PyTorch oracles for the attention kernels (port of ``kernels/ref.py``).

Each function is the semantic ground truth its kernel and plain version are
held against. Only the attention oracles are ported in this slice;
``matmul_ref``, ``conv2d_ref`` and the ``ssd_*`` oracles come with their
kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,      # (B, Hq, Sq, D)
    k: torch.Tensor,      # (B, Hkv, Sk, D)
    v: torch.Tensor,      # (B, Hkv, Sk, D)
    causal: bool = True,
    window: int = 0,      # 0 = full; else sliding window size
    q_offset: Optional[int] = None,  # absolute position of q[0]
) -> torch.Tensor:
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    sk = k.shape[2]
    qf = (q.float() / (d ** 0.5)).reshape(b, hkv, g, sq, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    off = q_offset if q_offset is not None else sk - sq
    qpos = off + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    # fully-masked rows (can happen with tiny windows) -> zeros, not NaN
    p = torch.where(mask.any(-1)[:, None], p, torch.zeros((), device=q.device))
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def phys_slots(tables: torch.Tensor, sc: int, page: int) -> torch.Tensor:
    """Physical slot index for every logical slot 0..sc-1 of every row.

    tables: (B, n_pages) int32 page table -> (B, sc) int64 flat-stack slots.
    Mirrors ``models/attention.py::paged_slots`` over a dense slot range."""
    n_pages = tables.shape[1]
    i = torch.arange(sc, device=tables.device)
    lp = torch.clamp(i // page, 0, n_pages - 1)
    entry = tables.long()[:, lp]
    return entry * page + i % page


def paged_decode_ref(
    q: torch.Tensor,        # (B, 1, Hq, D)
    k_cache: torch.Tensor,  # (n_slots, Hkv, D) flat slot stack
    v_cache: torch.Tensor,  # (n_slots, Hkv, D)
    tables: torch.Tensor,   # (B, n_pages) int32
    pos: torch.Tensor,      # (B,) or () int32
    *,
    page: int,
    sc: int,
    window: int = 0,        # >0: rotating per-row cache of modulus sc
) -> torch.Tensor:
    """Semantic ground truth for the paged decode kernel: gather every
    logical slot, expand GQA heads, and apply the decode validity rule
    verbatim — including the rotating-window arithmetic that the kernel
    reduces to ``i < min(pos + 1, sc)``."""
    bsz, _, hq, d = q.shape
    hkv = k_cache.shape[1]
    g = hq // hkv
    n_slots = k_cache.shape[0]
    posb = pos.reshape(-1).long().expand(bsz)[:, None]
    i = torch.arange(sc, device=q.device)[None, :]
    if window > 0:
        p_i = posb - torch.remainder(posb - i, sc)
        valid = (p_i >= 0) & (p_i <= posb)
    else:
        valid = i <= posb
    phys = torch.clamp(phys_slots(tables, sc, page), max=n_slots - 1)
    ke = k_cache[phys].repeat_interleave(g, dim=2)             # (B, sc, Hq, D)
    ve = v_cache[phys].repeat_interleave(g, dim=2)
    qf = q.float()[:, 0] * (d ** -0.5)                         # (B, Hq, D)
    s = torch.einsum("bhd,bkhd->bhk", qf, ke.float())
    s = torch.where(valid[:, None, :], s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", p, ve.float())
    return o[:, None].to(q.dtype)
