"""Paged-attention decode: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/paged_attention.py``. One query token per row
attends to a flat slot stack ``(n_slots, Hkv, D)`` through a ``(B, n_pages)``
int32 page table; only the committed slots ``i < min(pos + 1, Sc)`` count.
That one mask serves rotating and non-rotating caches alike: for a single
query at ``pos`` both validity rules reduce to it (``kernels/ref.py``'s
``paged_decode_ref`` applies the literal rules, and the tests prove the
reduction).

- :func:`paged_decode_attention` is the kernel wrapper: on a CUDA tensor it
  launches ``csrc/paged_decode.cu`` (raising on anything the kernel does not
  take), on a CPU tensor it runs the plain version.
- :func:`paged_attention_torch` is the plain version, a port of
  ``paged_attention_xla``: committed-slot mask, uncommitted slots pinned to
  slot 0, one gather, scores in grouped (kv-head) form with no GQA
  expansion.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, phys_slots

# limits of csrc/paged_decode.cu (kMaxG, kMaxD, kThreads * kMaxElems, kSplit)
MAX_GROUP = 16
MAX_HEAD_DIM = 256
MAX_GROUP_X_DIM = 2048
SPLIT_SLOTS = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    if g > MAX_GROUP or d > MAX_HEAD_DIM or g * d > MAX_GROUP_X_DIM:
        raise ValueError(f"paged_decode kernel takes g <= {MAX_GROUP}, "
                         f"D <= {MAX_HEAD_DIM}, g*D <= {MAX_GROUP_X_DIM}; "
                         f"got g={g}, D={d}")
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
    """Kernel wrapper: launches ``csrc/paged_decode.cu`` on a CUDA tensor
    (counting the launch in ``paged_decode_attention.launches``), runs
    :func:`paged_attention_torch` on a CPU tensor."""
    if q.device.type == "cpu":
        return paged_attention_torch(q, k_cache, v_cache, tables, pos,
                                     page=page, sc=sc)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode kernel runs on CUDA tensors, got {q.device}")
    _check(q, k_cache, v_cache, tables, pos, page, sc)
    bsz, _, hq, d = q.shape
    hkv = k_cache.shape[1]
    g = hq // hkv
    n_tab = tables.shape[1]
    n_splits = -(-min(sc, n_tab * page) // SPLIT_SLOTS)
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
            d, n_tab, page, sc, k_cache.shape[0] // page, n_splits, SPLIT_SLOTS,
            1.0 / (d ** 0.5), stream)
    paged_decode_attention.launches += 1
    if err:
        raise RuntimeError(f"paged_decode launch failed: cudaError_t {err}")
    return out


paged_decode_attention.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.paged_decode.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                                 + [ctypes.c_float, ctypes.c_void_p])
    lib.paged_decode.restype = ctypes.c_int

