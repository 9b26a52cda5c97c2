"""Operator dispatch for the kernels (port of ``kernels/ops.py``).

``BACKEND`` picks the physical operator:

- ``"auto"``: the kernel wrapper, which launches the CUDA kernel for a CUDA
  tensor and runs the plain version for a CPU tensor;
- ``"kernel"``: the CUDA kernel, raising for a tensor that is not on CUDA;
- ``"torch"``: the plain PyTorch version on any device.

The reference's ``_fits_vmem`` fallback becomes each wrapper's own shape
check: a shape the kernel cannot take raises with the reason. Nothing falls
back to the plain version when the tensor is on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention, flash_attention_torch
from repro_torch.kernels.paged_attention import (paged_attention_torch,
                                                 paged_decode_attention)
from repro_torch.kernels.ssd_scan import MAX_CHUNK, ssd_scan, ssd_scan_torch

BACKEND = "auto"
_BACKENDS = ("auto", "kernel", "torch")


def _use_plain(x: torch.Tensor) -> bool:
    if BACKEND not in _BACKENDS:
        raise ValueError(f"ops.BACKEND must be one of {_BACKENDS}, got {BACKEND!r}")
    if BACKEND == "kernel" and x.device.type != "cuda":
        raise ValueError(f"ops.BACKEND='kernel' needs CUDA tensors, got {x.device}")
    return BACKEND == "torch"


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: Optional[int] = None):
    """q (B, Hq, Sq, D); k/v (B, Hkv, Sk, D) in kv-head form."""
    off = -1 if q_offset is None else q_offset
    fn = flash_attention_torch if _use_plain(q) else flash_attention
    return fn(q, k, v, causal=causal, window=window, q_offset=off)


def paged_attention(q, k_cache, v_cache, tables, pos, *, page: int, sc: int):
    """Fused paged-decode attention; page tables resolved inside the op."""
    fn = paged_attention_torch if _use_plain(q) else paged_decode_attention
    return fn(q, k_cache, v_cache, tables, pos, page=page, sc=sc)


def ssd(x, dt, a, b_mat, c_mat, d, *, chunk: int = MAX_CHUNK):
    """Mamba-2 SSD over x (B, S, H, P) at ``chunk = min(chunk, S)``; y in
    x's dtype."""
    fn = ssd_scan_torch if _use_plain(x) else ssd_scan
    return fn(x, dt, a, b_mat, c_mat, d, chunk=chunk)
