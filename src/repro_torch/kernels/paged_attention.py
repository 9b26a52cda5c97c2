"""Paged-attention decode: the CUDA kernels' wrapper and its plain versions.

Port of ``repro/kernels/paged_attention.py``. One query token per row
attends to a flat slot stack ``(n_slots, Hkv, D)`` through a ``(B, n_pages)``
int32 page table; only the committed slots ``i < min(pos + 1, Sc)`` count.
That one mask serves rotating and non-rotating caches alike: for a single
query at ``pos`` both validity rules reduce to it (``kernels/ref.py``'s
``paged_decode_ref`` applies the literal rules, and the tests prove the
reduction).

- :func:`paged_decode_attention` is the kernel wrapper, the custom op
  ``repro_torch::paged_decode_attention``: on a CUDA tensor it launches
  ``csrc/paged_decode.cu`` (raising on anything the kernel does not take),
  on a CPU tensor it runs the plain version; :func:`work` counts a call's
  FLOPs and bytes. bfloat16 at a head dim
  that is a multiple of 16 runs ``paged_mma_kernel`` (tensor cores, per-warp
  ``cp.async`` rings, splits sized by :func:`split_plan`); float32, and
  bfloat16 at other head dims, run ``paged_split_kernel`` (CUDA cores,
  128-slot splits); :func:`kernel_name` says which. A second kernel,
  ``paged_combine_kernel``, merges the splits.
- :func:`paged_attention_torch` is the plain version, a port of
  ``paged_attention_xla``: committed-slot mask, uncommitted slots pinned to
  slot 0, one gather, scores in grouped (kv-head) form with no GQA
  expansion.
- :func:`paged_attention_model` is the plain version in the kernels' order:
  per-split partials (max in log2 units, denominator, accumulator) and
  their combine, with P split into bfloat16 hi + lo before P.V as
  ``paged_mma_kernel`` splits it; returns float32, unrounded.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.hw import H100_SMS, sm_count
from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, phys_slots

# limits of csrc/paged_decode.cu (kMaxG, kMaxD); every g * D within them
# fits the split kernel's accumulator
MAX_GROUP = 16
MAX_HEAD_DIM = 256
# slots per split of paged_split_kernel (kSplit)
SPLIT_SLOTS = 128
# paged_mma_kernel: 64-slot tiles (16 slots to each of 4 warps), a split is
# a whole number of tiles; splits are sized for as many blocks as fit on
# every SM: two of the instantiations up to D = 128, one of D = 256 (its
# 211 KB of shared memory)
TILE_SLOTS = 64
LOG2E = 1.4426950408889634

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_name(d: int, dtype: torch.dtype) -> str:
    """The split kernel of ``csrc/paged_decode.cu`` that a call at head dim
    d in dtype runs (the C entry point dispatches on both)."""
    if dtype == torch.bfloat16 and d % 16 == 0:
        return "paged_mma_kernel"
    return "paged_split_kernel"


def blocks_per_sm(d: int) -> int:
    """Blocks of ``paged_mma_kernel`` that fit an SM at head dim d."""
    return 2 if d <= 128 else 1


def split_plan(bsz: int, hkv: int, n: int, d: int, dtype: torch.dtype,
               sms: int = H100_SMS) -> Tuple[int, int]:
    """(slots per split, splits) for ``n = min(sc, n_tab * page)`` slots per
    row. ``paged_split_kernel`` takes ``SPLIT_SLOTS``. ``paged_mma_kernel``
    takes a whole number of ``TILE_SLOTS`` tiles, as few as give the B * Hkv
    (row, kv head) pairs about :func:`blocks_per_sm` blocks on each of
    ``sms`` SMs: on 132 SMs the Yi (8, 2048) bucket's 32 pairs take 8 splits
    of 256 slots (256 blocks), recurrentgemma's 8 pairs at D = 256 16 splits
    of 128 (128 blocks). Rows' positions are not read (the host would have
    to wait for the device), so a split past a row's committed slots is
    planned and exits at once."""
    if kernel_name(d, dtype) == "paged_split_kernel":
        return SPLIT_SLOTS, max(1, -(-n // SPLIT_SLOTS))
    tiles = max(1, -(-n // TILE_SLOTS))
    want = max(1, blocks_per_sm(d) * sms // (bsz * hkv))
    slots = -(-tiles // want) * TILE_SLOTS
    return slots, max(1, -(-n // slots))


def paged_attention_torch(
    q: torch.Tensor,        # (B, 1, Hq, D)
    k_cache: torch.Tensor,  # (n_slots, Hkv, D)
    v_cache: torch.Tensor,  # (n_slots, Hkv, D)
    tables: torch.Tensor,   # (B, n_pages) int32
    pos: torch.Tensor,      # (B,) int32
    *,
    page: int,
    sc: int,
) -> torch.Tensor:
    """Plain PyTorch form of the fused operator (port of
    ``paged_attention_xla``)."""
    bsz, _, hq, d = q.shape
    hkv = k_cache.shape[1]
    g = hq // hkv
    n_slots = k_cache.shape[0]
    posb = pos.reshape(-1).long().expand(bsz)
    n_valid = torch.clamp(posb + 1, max=sc)[:, None]                 # (B, 1)
    valid = torch.arange(sc, device=q.device)[None, :] < n_valid      # (B, Sc)
    phys = torch.clamp(phys_slots(tables, sc, page), max=n_slots - 1)
    phys = torch.where(valid, phys, torch.zeros((), dtype=phys.dtype,
                                                device=q.device))
    ke = k_cache[phys]                                               # (B, Sc, Hkv, D)
    ve = v_cache[phys]
    qf = q.float()[:, 0].reshape(bsz, hkv, g, d) * (d ** -0.5)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, ke.float())
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, ve.float())
    return o.reshape(bsz, hq, d)[:, None].to(q.dtype)


def paged_attention_model(
    q: torch.Tensor,        # (B, 1, Hq, D)
    k_cache: torch.Tensor,  # (n_slots, Hkv, D)
    v_cache: torch.Tensor,  # (n_slots, Hkv, D)
    tables: torch.Tensor,   # (B, n_pages) int32
    pos: torch.Tensor,      # (B,) int32
    *,
    page: int,
    sc: int,
    split_slots: Optional[int] = None,
    p_terms: Optional[int] = None,
    sms: int = H100_SMS,
) -> torch.Tensor:
    """Plain version in the kernels' order -> float32 (B, 1, Hq, D),
    unrounded.

    The ``n = min(sc, n_tab * page)`` slots are cut into splits of
    ``split_slots`` (default: :func:`split_plan` of the kernel this call
    would run on ``sms`` SMs). Each split keeps the max ``m`` of its scores
    ``q.k`` times ``c = D^-0.5 * log2(e)``, ``p = exp2(q.k * c - m)`` (0
    where masked), its denominator ``sum p`` and its accumulator ``P.V``,
    with P taken as
    ``p_terms`` bfloat16 parts: 2 (``paged_mma_kernel``: hi + lo), 1 (P
    rounded to bfloat16 alone, which the kernel does not do) or 0 (float32 P,
    ``paged_split_kernel``; default by :func:`kernel_name`). The combine
    weighs split s by ``exp2(m_s - max m)``; a row with nothing committed
    gives zeros."""
    bsz, _, hq, d = q.shape
    hkv = k_cache.shape[1]
    g = hq // hkv
    n_slots = k_cache.shape[0]
    n = min(sc, tables.shape[1] * page)
    plan_slots, _ = split_plan(bsz, hkv, n, d, q.dtype, sms)
    split_slots = plan_slots if split_slots is None else split_slots
    if p_terms is None:
        p_terms = 2 if kernel_name(d, q.dtype) == "paged_mma_kernel" else 0
    n_splits = -(-n // split_slots)
    width = n_splits * split_slots
    posb = pos.reshape(-1).long().expand(bsz)
    n_valid = torch.clamp(posb + 1, max=n)[:, None]                   # (B, 1)
    valid = torch.arange(width, device=q.device)[None, :] < n_valid   # (B, W)
    phys = torch.clamp(phys_slots(tables, n, page), max=n_slots - 1)
    phys = torch.nn.functional.pad(phys, (0, width - n))
    phys = torch.where(valid, phys, torch.zeros((), dtype=phys.dtype, device=q.device))
    ke = k_cache[phys].float()                                       # (B, W, Hkv, D)
    ve = v_cache[phys].float()
    c32 = np.float32(np.float32(1.0 / (d ** 0.5)) * np.float32(LOG2E))
    c = float(c32)  # lint: allow-tracer-host-sync (a numpy scalar)
    qf = q.float()[:, 0].reshape(bsz, hkv, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, ke) * c                  # (B, Hkv, g, W)
    s = torch.where(valid[:, None, None, :], s, torch.full((), NEG_INF, device=q.device))
    s = s.reshape(bsz, hkv, g, n_splits, split_slots)
    ok = valid.reshape(bsz, 1, 1, n_splits, split_slots)
    m = s.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp2(s - m), 0.0)
    l = p.sum(-1)                                                    # (B, Hkv, g, S)
    if p_terms == 0:
        parts = [p]
    else:
        hi = p.to(torch.bfloat16).float()
        parts = [hi] if p_terms == 1 else [hi, (p - hi).to(torch.bfloat16).float()]
    vs = ve.reshape(bsz, n_splits, split_slots, hkv, d)
    acc = sum(torch.einsum("bhgsk,bskhd->bhgsd", part, vs) for part in parts)
    m = m[..., 0]
    w = torch.exp2(m - m.amax(-1, keepdim=True))
    num = (w[..., None] * acc).sum(-2)                               # (B, Hkv, g, D)
    den = (w * l).sum(-1)[..., None]
    out = num / torch.where(den == 0, 1.0, den)
    return out.reshape(bsz, hq, d)[:, None]


def _check(q, k_cache, v_cache, tables, pos, page, sc) -> None:
    """Raise with the reason on anything the CUDA kernel does not take."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, Hq, D), got {tuple(q.shape)}")
    bsz, _, hq, d = q.shape
    if k_cache.dim() != 3 or k_cache.shape != v_cache.shape:
        raise ValueError(f"k/v caches must both be (n_slots, Hkv, D), got "
                         f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    n_slots, hkv, dk = k_cache.shape
    if dk != d or hkv < 1 or hq % hkv:
        raise ValueError(f"head shapes do not match: q {tuple(q.shape)}, "
                         f"cache {tuple(k_cache.shape)}")
    g = hq // hkv
    if g > MAX_GROUP or d > MAX_HEAD_DIM:
        raise ValueError(f"paged_decode kernel takes g <= {MAX_GROUP}, "
                         f"D <= {MAX_HEAD_DIM}; got g={g}, D={d}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"paged_decode kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if (d * q.element_size()) % 16 or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("paged_decode kernel stages K/V rows with 16-byte loads: "
                         "D * itemsize and the cache base addresses must be "
                         "multiples of 16")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"tables and pos must be int32, got {tables.dtype} and "
                        f"{pos.dtype}")
    if tables.dim() != 2 or tables.shape[0] != bsz or tuple(pos.shape) != (bsz,):
        raise ValueError(f"tables must be (B, n_pages) and pos (B,) for B={bsz}, "
                         f"got {tuple(tables.shape)} and {tuple(pos.shape)}")
    if page < 1 or n_slots < page:
        raise ValueError(f"page={page} must be >= 1 and fit the {n_slots}-slot stack")
    if sc > tables.shape[1] * page:
        raise ValueError(f"sc={sc} exceeds the table's {tables.shape[1]} pages "
                         f"of {page} slots")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("tables", tables), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def work(q, k_cache, v_cache, tables, pos, page: int, sc: int,
         slots: Optional[int] = None) -> _build.Work:
    """FLOPs and bytes of one call: ``q.k`` and ``p.v`` over ``slots``
    committed (row, slot) pairs, each committed K/V slot read once, q read and
    the output written, the table and positions read. ``slots`` defaults to
    every slot of every row (``B * min(sc, n_pages * page)``); a caller
    holding the positions passes ``sum(min(pos + 1, sc))``."""
    b, _, hq, d = q.shape
    hkv = k_cache.shape[1]
    item = q.element_size()
    if slots is None:
        slots = b * min(sc, tables.shape[1] * page)
    nbytes = (slots * hkv * d * 2 * item + 2 * b * hq * d * item
              + tables.numel() * 4 + b * 4)
    return _build.Work(4 * hq * d * slots, nbytes)


def _launch(q, k_cache, v_cache, tables, pos, page, sc):
    """CUDA implementation of ``repro_torch::paged_decode_attention``:
    :func:`kernel_name`'s split kernel, then the combine; counted once in
    ``paged_decode_attention.launches``."""
    _check(q, k_cache, v_cache, tables, pos, page, sc)
    bsz, _, hq, d = q.shape
    hkv = k_cache.shape[1]
    g = hq // hkv
    n_tab = tables.shape[1]
    split_slots, n_splits = split_plan(bsz, hkv, min(sc, n_tab * page), d, q.dtype,
                                       sm_count(q.device))
    lib = _build.library("paged_decode", _bind)
    out = torch.empty_like(q)
    # per-split (max, denominator, accumulator) partials for the combine pass
    part_acc = torch.empty((bsz, hkv, n_splits, g, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((bsz, hkv, n_splits, g, 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), _DTYPES[q.dtype], bsz, hkv, g,
            d, n_tab, page, sc, k_cache.shape[0] // page, n_splits, split_slots,
            1.0 / (d ** 0.5), stream)
    paged_decode_attention.launches += 1
    if err:
        raise RuntimeError(f"paged_decode launch failed: cudaError_t {err}")
    return out


def _fake(q, k_cache, v_cache, tables, pos, page, sc):
    return torch.empty_like(q)


@_build.kernel_op("paged_decode_attention", work, _launch, _fake)
def _paged_decode_op(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     tables: torch.Tensor, pos: torch.Tensor, page: int,
                     sc: int) -> torch.Tensor:
    return paged_attention_torch(q, k_cache, v_cache, tables, pos, page=page, sc=sc)


@_build.counted
def paged_decode_attention(
    q: torch.Tensor,        # (B, 1, Hq, D) — one new token per row
    k_cache: torch.Tensor,  # (n_slots, Hkv, D) flat slot stack
    v_cache: torch.Tensor,  # (n_slots, Hkv, D)
    tables: torch.Tensor,   # (B, n_pages) int32; unallocated entries >= n_phys
    pos: torch.Tensor,      # (B,) int32 absolute position of the new token
    *,
    page: int,
    sc: int,                # logical cache length per row (bucket Sc)
) -> torch.Tensor:
    """Kernel wrapper: the custom op ``repro_torch::paged_decode_attention``,
    which launches ``csrc/paged_decode.cu`` on a CUDA tensor and runs
    :func:`paged_attention_torch` on a CPU tensor."""
    _build.require_cpu_or_cuda(q, "paged_decode kernel")
    return _paged_decode_op(q, k_cache, v_cache, tables, pos, page, sc)


def _bind(lib: ctypes.CDLL) -> None:
    lib.paged_decode.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                                 + [ctypes.c_float, ctypes.c_void_p])
    lib.paged_decode.restype = ctypes.c_int

