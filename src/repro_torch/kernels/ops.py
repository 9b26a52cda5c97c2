"""Operator dispatch for the kernels (port of ``kernels/ops.py``).

``BACKEND`` picks the physical operator:

- ``"auto"``: the kernel wrapper, which launches the CUDA kernel for a CUDA
  tensor and runs the plain version for a CPU tensor;
- ``"kernel"``: the CUDA kernel, raising for a tensor that is not on CUDA;
- ``"torch"``: the plain PyTorch version on any device.

The reference's ``_fits_vmem`` fallback becomes each wrapper's own shape
check: a shape the kernel cannot take raises with the reason. Nothing falls
back to the plain version when the tensor is on the card.

Where autograd records a call (a training step), attention, the SSD scan
and the RG-LRU scan take their kernels' training ops, whose registered
gradients are the flash recompute rule and the scans' backward kernels;
under ``"torch"`` autograd runs through the plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.conv2d_im2col import conv2d_im2col, conv2d_torch
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_torch,
                                                 flash_attention_train, flash_decode,
                                                 flash_decode_torch)
from repro_torch.kernels.matmul import matmul as matmul_kernel
from repro_torch.kernels.matmul import matmul_torch
from repro_torch.kernels.paged_attention import (paged_attention_torch,
                                                 paged_decode_attention)
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_torch, rglru_scan_train
from repro_torch.kernels.ssd_scan import MAX_CHUNK, ssd_scan, ssd_scan_torch, ssd_scan_train

BACKEND = "auto"
_BACKENDS = ("auto", "kernel", "torch")


def _use_plain(x: torch.Tensor) -> bool:
    if BACKEND not in _BACKENDS:
        raise ValueError(f"ops.BACKEND must be one of {_BACKENDS}, got {BACKEND!r}")
    if BACKEND == "kernel" and x.device.type != "cuda":
        raise ValueError(f"ops.BACKEND='kernel' needs CUDA tensors, got {x.device}")
    return BACKEND == "torch"


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with a float32 accumulator, in a's dtype."""
    fn = matmul_torch if _use_plain(a) else matmul_kernel
    return fn(a, b)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """x (N, C, H, W) * w (F, C, k, k) -> (N, F, Ho, Wo) in x's dtype. The
    kernel is an implicit GEMM: unlike the reference's per-image VMEM fit,
    it has no per-image size limit."""
    fn = conv2d_torch if _use_plain(x) else conv2d_im2col
    return fn(x, w, stride=stride, pad=pad)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: Optional[int] = None):
    """q (B, Hq, Sq, D); k/v (B, Hkv, Sk, D) in kv-head form."""
    off = -1 if q_offset is None else q_offset
    fn = flash_attention_torch if _use_plain(q) else flash_attention
    return fn(q, k, v, causal=causal, window=window, q_offset=off)


def attention_decode(q, k, v, *, causal: bool = True, window: int = 0,
                     q_offset: Optional[int] = None):
    """One query row a batch row: q (B, Hq, D) against k/v (B, Sk, Hkv, D)
    in the model's layout, read in place (``flash_decode``)."""
    off = -1 if q_offset is None else q_offset
    fn = flash_decode_torch if _use_plain(q) else flash_decode
    return fn(q, k, v, causal=causal, window=window, q_offset=off)


def attention_train(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: Optional[int] = None):
    """The training forward, q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D): the
    output of ``flash_attention_train``, whose gradient from the kernel's
    ``(out, lse)`` is the backward kernel ``flash_attention_bwd`` (the
    reference's recompute rule on a CPU tensor); under
    ``BACKEND = "torch"``, autograd through the plain full-score form."""
    off = -1 if q_offset is None else q_offset
    if _use_plain(q):
        return flash_attention_torch(q, k, v, causal=causal, window=window, q_offset=off)
    return flash_attention_train(q, k, v, causal=causal, window=window, q_offset=off)[0]


def paged_attention(q, k_cache, v_cache, tables, pos, *, page: int, sc: int):
    """Fused paged-decode attention; page tables resolved inside the op."""
    fn = paged_attention_torch if _use_plain(q) else paged_decode_attention
    return fn(q, k_cache, v_cache, tables, pos, page=page, sc=sc)


def records_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd records a call on ``ts`` (a training step)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def ssd(x, dt, a, b_mat, c_mat, d, *, chunk: int = MAX_CHUNK):
    """Mamba-2 SSD over x (B, S, H, P) at ``chunk = min(chunk, S)``; y in
    x's dtype. Where autograd records the call, the training forward
    ``ssd_scan_train``, whose gradient is the ``ssd_scan_bwd`` kernel; under
    ``BACKEND = "torch"``, autograd through the plain version."""
    if _use_plain(x):
        return ssd_scan_torch(x, dt, a, b_mat, c_mat, d, chunk=chunk)
    if records_grad(x, dt, a, b_mat, c_mat, d):
        return ssd_scan_train(x, dt, a, b_mat, c_mat, d, chunk=chunk)[0]
    return ssd_scan(x, dt, a, b_mat, c_mat, d, chunk=chunk)


def rglru(xb, r_pre, i_pre, y_pre, c, lengths=None):
    """The RG-LRU gates, recurrence and output product over (B, S, W):
    ``(y in xb's dtype, the float32 state at each row's lengths - 1)``.
    Where autograd records the call (a training step, which hands no decode
    state on), ``(y, None)`` from the training forward ``rglru_scan_train``,
    whose gradient is the ``rglru_scan_bwd`` kernel; under ``BACKEND =
    "torch"``, autograd through the plain version."""
    if _use_plain(xb):
        return rglru_scan_torch(xb, r_pre, i_pre, y_pre, c, lengths)
    if records_grad(xb, r_pre, i_pre, y_pre, c):
        if lengths is not None:
            raise ValueError("the RG-LRU training forward takes whole rows (lengths=None)")
        return rglru_scan_train(xb, r_pre, i_pre, y_pre, c)[0], None
    return rglru_scan(xb, r_pre, i_pre, y_pre, c, lengths)
