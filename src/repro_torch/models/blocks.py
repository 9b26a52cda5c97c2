"""The attention block (port of the dense part of ``repro/models/blocks.py``).

``attn_block_params(cfg)`` gives the per-layer specs, ``attn_block_apply``
the full-sequence forward (prefill), ``attn_block_decode`` the one-token
forward with its cache write. The SSD, RG-LRU and MoE blocks come with the
slices that port their families.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import attention as ATT
from repro_torch.models.common import rms_norm, rope, swiglu

DECODE_KERNELS = ("paged", "gather", "ref")


def attn_block_params(cfg: ModelConfig) -> Dict:
    d, hq, kv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    return {
        "ln1": ((d,), (None,), "ones"),
        "wq": ((d, hq, hd), ("embed", "q_heads", "head_dim"), "normal"),
        "wk": ((d, kv, hd), ("embed", "kv_heads", "head_dim"), "normal"),
        "wv": ((d, kv, hd), ("embed", "kv_heads", "head_dim"), "normal"),
        "wo": ((hq, hd, d), ("q_heads", "head_dim", "embed_out"), "normal"),
        "ln2": ((d,), (None,), "ones"),
        "wg": ((d, f), ("embed", "ffn"), "normal"),
        "wu": ((d, f), ("embed", "ffn"), "normal"),
        "wd": ((f, d), ("ffn", "embed_out"), "normal"),
    }


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


def _ffn(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["wg"], p["wu"], p["wd"])


def attn_block_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                     positions: torch.Tensor, *, causal: bool = True,
                     window: int = 0):
    """Full-sequence forward. Returns ``(x_out, {"k", "v"})`` — the rope'd
    K/V in kv-head cache-row form ``(B, S, Kv, Dh)`` for the prefill→decode
    handoff."""
    h = rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h, positions)
    o = ATT.attention(q, k, v, causal=causal, window=window)
    x = x + _out_proj(o, p["wo"])
    out = x + _ffn(p, rms_norm(x, p["ln2"]))
    return out, {"k": k, "v": v}


def attn_block_decode(
    cfg: ModelConfig, p: Dict, x: torch.Tensor, cache: Dict, pos: torch.Tensor,
    *, window: int = 0, tables: Optional[torch.Tensor] = None, page: int = 0,
    sc: int = 0, decode_kernel: str = "gather",
) -> torch.Tensor:
    """x: (B, 1, D). cache: {"k", "v"} — dense ``(B, Sc, Kv, Dh)`` rows, or
    with ``tables``/``page``/``sc`` flat ``(n_slots, Kv, Dh)`` slot stacks
    read through each row's page table. The cache is written in place.
    ``pos`` is a scalar or a (B,) int32 vector. ``decode_kernel`` picks the
    paged read: "paged" (the fused kernel through ``kernels.ops``),
    "gather" (gathered view + dense decode attention) or "ref" (the
    oracle)."""
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
    return x + _ffn(p, rms_norm(x, p["ln2"]))


def attn_cache_spec(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    """Per-layer cache shapes + logical axes."""
    kvshape = (batch, seq, cfg.num_kv_heads, cfg.head_dim)
    axes = ("batch", "seq", "kv_heads", "head_dim")
    return {"k": (kvshape, axes), "v": (kvshape, axes)}
