"""Shared model substrate: param specs, RMSNorm, RoPE, SwiGLU, the training
loss (``softmax_xent_logits``), the causal depthwise convolution of the SSM
block.

Port of ``repro/models/common.py`` for one device: the reference's
``ShardCtx`` (sharding hints under a device mesh) has no counterpart here.
Parameters travel as flat dicts of tensors keyed exactly as the reference's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


class SpecBuilder:
    """Collects (shape, axes, init) triples and materializes initialized
    tensors with the reference's shapes, keys and scales. The numbers differ
    from the reference's (``torch.Generator`` is not ``jax.random``); tests
    that need both packages on one set of weights convert them with
    ``repro_torch.interop``."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        self.dtype = dtype
        self.entries: Dict[str, Any] = {}

    def add(self, name: str, shape: Tuple[int, ...],
            axes: Tuple[Optional[str], ...], init: str = "normal",
            scale: Optional[float] = None, dtype: Optional[torch.dtype] = None):
        if len(shape) != len(axes):
            raise ValueError(f"{name}: shape {shape} and axes {axes} differ in rank")
        self.entries[name] = (tuple(shape), tuple(axes), init, scale,
                              dtype or self.dtype)
        return self

    def shapes(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        return {k: (sh, dt) for k, (sh, _ax, _ini, _sc, dt) in self.entries.items()}

    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Initialize every entry on ``generator.device``, in entry order."""
        dev = generator.device
        out = {}
        for k, (sh, _ax, ini, sc, dt) in self.entries.items():
            if ini == "zeros":
                out[k] = torch.zeros(sh, dtype=dt, device=dev)
            elif ini == "ones":
                out[k] = torch.ones(sh, dtype=dt, device=dev)
            elif ini == "ssm_a":
                # A_log init: log of uniform [1, 16] (mamba2 convention)
                u = torch.rand(sh, generator=generator, dtype=torch.float32,
                               device=dev)
                out[k] = torch.log(1.0 + 15.0 * u).to(dt)
            else:
                fan_in = sh[-2] if len(sh) >= 2 else sh[-1]
                s = sc if sc is not None else 1.0 / math.sqrt(max(1, fan_in))
                w = torch.randn(sh, generator=generator, dtype=torch.float32,
                                device=dev)
                out[k] = w.mul_(s).to(dt)
                # the float32 draw goes before the next one is made: a
                # stacked expert tensor's is 24 GiB at 8 Qwen3-MoE layers
                del w
        return out


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Fixed ``eps`` (not ``cfg.norm_eps``) and the cast back to ``x.dtype``
    *before* the ``gamma`` product, as the reference does."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split ("rotate-half") rotary embedding, angles in float32.
    x: (..., S, H, D); positions broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs                 # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SiLU in float32, cast to ``x.dtype`` before the product with ``u``."""
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, w_down)


def softmax_xent_logits(logits: torch.Tensor, targets: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (..., V) -> the float32 mean cross-entropy of ``targets``
    (...), over the positions ``mask`` keeps where it is given (at least
    one, as the reference divides by ``max(sum(mask), 1)``)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    nll = lse - tgt
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal convolution. x (B, S, C), w (W, C); the sum of the
    W shifted products is taken in float32 and rounded to ``x.dtype`` once.
    With ``state`` (B, W-1, C) — the last W-1 inputs before x — it is the
    single-step decode form (S == 1) and returns ``(y, new_state)``."""
    wd = w.shape[0]
    wf = w.float()
    if state is not None:
        full = torch.cat([state, x], dim=1)                       # (B, W, C)
        y = torch.einsum("bwc,wc->bc", full[:, -wd:].float(), wf)[:, None, :]
        return y.to(x.dtype), full[:, 1:]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, wd - 1, 0))                              # zeros before t=0
    y = xp[:, 0:s].float() * wf[0]
    for i in range(1, wd):
        y += xp[:, i:i + s].float() * wf[i]
    return y.to(x.dtype)
