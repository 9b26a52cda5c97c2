"""Plain PyTorch oracles for the kernels (port of ``kernels/ref.py``).

Each function is the semantic ground truth its kernel and plain version are
held against: ``matmul_ref``, ``conv2d_ref``, the attention oracles and the
Mamba-2 SSD oracles (``ssd_ref``, the sequential scan, and
``ssd_chunked_ref``, the chunked form). ``conv2d_ref`` is the library
convolution; nothing on the port's path calls it.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# TF32 rounding: the float32 kernels' 3xTF32 models (matmul, conv2d, ssd)
# ---------------------------------------------------------------------------

def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 significand bits), ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds finite values: add half of
    the dropped 13 bits to the magnitude, then clear them."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(t: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by clearing the 13 low significand bits: how the
    tensor cores read a float32 operand of a TF32 product."""
    return (t.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) in float32, rounded to a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


# ---------------------------------------------------------------------------
# conv2d via im2col (paper ref [5]) — NCHW, square kernel
# ---------------------------------------------------------------------------

def conv2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """x: (N, C, H, W); w: (F, C, k, k) -> (N, F, Ho, Wo), in float32,
    rounded to x's dtype."""
    out = torch.nn.functional.conv2d(x.float(), w.float(), stride=stride, padding=pad)
    return out.to(x.dtype)


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


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality): sequential-scan semantics
# ---------------------------------------------------------------------------


def _ssd_inputs(x, dt, a, b_mat, c_mat, init_state):
    bsz, _s, h, p = x.shape
    n = b_mat.shape[-1]
    state0 = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
              if init_state is None else init_state.float())
    return x.float(), dt.float(), a.float(), b_mat.float(), c_mat.float(), state0


def ssd_ref(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)   softplus-activated step sizes
    a: torch.Tensor,      # (H,)        negative decay rates (A = -exp(a_log))
    b_mat: torch.Tensor,  # (B, S, N)
    c_mat: torch.Tensor,  # (B, S, N)
    d: torch.Tensor,      # (H,)        skip connection
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
):
    """Returns ``(y (B, S, H, P) in x's dtype, final_state (B, H, P, N)
    float32)``. Recurrence per head h:

        state_t = exp(dt_t a_h) state_{t-1} + dt_t x_t b_t^T
        y_t     = state_t c_t + d_h x_t
    """
    xf, dtf, af, bf, cf, state = _ssd_inputs(x, dt, a, b_mat, c_mat, init_state)
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(dtf[:, t] * af[None, :])                   # (B, H)
        upd = (dtf[:, t, :, None] * xf[:, t])[..., None] * bf[:, t, None, None, :]
        state = decay[..., None, None] * state + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, cf[:, t]))
    y = torch.stack(ys, dim=1) + d.float()[None, None, :, None] * xf
    return y.to(x.dtype), state


def ssd_chunked_ref(x, dt, a, b_mat, c_mat, d, chunk: int = 16, init_state=None):
    """Chunked ("duality") form of :func:`ssd_ref`: within-chunk matrix
    products plus an inter-chunk state carry, the algorithm the kernel
    implements. Returns ``(y, final_state)`` like :func:`ssd_ref`."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    xf, dtf, af, bf, cf, state = _ssd_inputs(x, dt, a, b_mat, c_mat, init_state)
    xf = xf.reshape(bsz, nc, chunk, h, p)
    dtf = dtf.reshape(bsz, nc, chunk, h)
    bf = bf.reshape(bsz, nc, chunk, n)
    cf = cf.reshape(bsz, nc, chunk, n)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for ci in range(nc):
        xc, dtc, bc, cc = xf[:, ci], dtf[:, ci], bf[:, ci], cf[:, ci]
        cum = torch.cumsum(dtc * af[None, None, :], dim=1)         # (B, c, H)
        total = cum[:, -1]                                          # (B, H)
        # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j. Mask BEFORE
        # the exp: the i < j entries are positive and overflow to inf.
        li = cum[:, :, None, :] - cum[:, None, :, :]                # (B, c, c, H)
        lmat = torch.exp(torch.where(tri[None, :, :, None], li,
                                     torch.full((), NEG_INF, device=x.device)))
        scores = torch.einsum("bin,bjn->bij", cc, bc)               # (B, c, c)
        w = scores[..., None] * lmat
        dx = dtc[..., None] * xc                                    # (B, c, H, P)
        y_intra = torch.einsum("bijh,bjhp->bihp", w, dx)
        y_inter = torch.einsum("bhpn,bin->bihp", state, cc) * torch.exp(cum)[..., None]
        decay_to_end = torch.exp(total[:, None, :] - cum)           # (B, c, H)
        contrib = torch.einsum("bihp,bin->bhpn", dx * decay_to_end[..., None], bc)
        state = torch.exp(total)[..., None, None] * state + contrib
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, p)
    y = y + d.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), state
