"""The attention and Mamba-2 SSD blocks (port of ``repro/models/blocks.py``).

``*_block_params(cfg)`` gives a block's per-layer specs, ``*_block_apply``
its full-sequence forward (prefill), ``*_block_decode`` its one-token
forward with its in-place cache update. The RG-LRU and MoE blocks come with
the slices that port their families.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import attention as ATT
from repro_torch.models.common import causal_conv1d, rms_norm, rope, swiglu

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


def ssd_block_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
                    lengths: Optional[torch.Tensor] = None,
                    want_cache: bool = False):
    """Full-sequence forward. Returns ``x_out``, or with ``want_cache``
    ``(x_out, cache)`` where cache is the decode state after a per-row
    prompt of ``lengths`` tokens — {"state", "conv_x", "conv_b", "conv_c"}
    exactly as :func:`ssd_block_decode` consumes them. x, B and C enter the
    scan rounded to the model dtype; the prefill state is formed from their
    unrounded float32 values, as the reference does."""
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
    state = torch.matmul(wx.permute(0, 2, 3, 1), bm_f[:, None])      # (B, H, P, N)
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
