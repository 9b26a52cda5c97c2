"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/flash_attention.py``: GQA through ``bh // g``,
causal and/or sliding-window masks (``kpos > qpos - window``), ``q_offset``
(-1 means ``Sk - Sq``), an online softmax in float32 and fully-masked rows
giving zeros. K/V come in kv-head form ``(B, Hkv, Sk, D)``: the GQA
expansion is never materialized.

- :func:`flash_attention` is the kernel wrapper: on a CUDA tensor it
  launches ``csrc/flash_attention.cu`` (raising on anything the kernel does
  not take), on a CPU tensor it runs the plain version. Unlike the TPU
  kernel it pads nothing: the ragged ``Sk`` tail is masked per element, so
  unaligned bidirectional attention needs no special case.
- :func:`flash_attention_torch` is the plain version: the same masks
  applied to the full score matrix (``kernels/ref.py::attention_ref`` with
  the kernel's ``q_offset`` convention).
- :func:`flash_attention_tiled` is the plain version in the kernel's own
  order and rounding (64-key tiles, a running max, P rounded to V's dtype
  before P.V), returning float32: in bfloat16 the kernel's output is then
  within its own rounding (half a bfloat16 ulp) of it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.hw import H100
from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, attention_ref

# head dims csrc/flash_attention.cu is instantiated for
HEAD_DIMS = (32, 64, 128)
BQ, BK = 64, 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory one block of the kernel takes at head dim d.
    bfloat16 (tensor cores): Q, K and V tiles of padded bf16 rows. float32:
    the query tile, the transposed K tile (reused for V) and the P tile."""
    if dtype == torch.bfloat16:
        return 3 * BQ * (d + 8) * 2
    return 4 * (BQ * d + max(d * (BK + 4), BK * d) + BQ * BK)


def flash_attention_torch(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = -1) -> torch.Tensor:
    """Plain version: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D)."""
    return attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=None if q_offset < 0 else q_offset)


def flash_attention_tiled(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = -1, bk: int = BK) -> torch.Tensor:
    """Plain version in the kernel's order: q (B, Hq, Sq, D), k/v
    (B, Hkv, Sk, D) -> float32 (B, Hq, Sq, D), unrounded.

    Keys are visited in tiles of ``bk``; each tile's scores are scaled after
    the dot product, the running max and denominator stay in float32, and P
    is rounded to V's dtype before the P.V product, as in
    ``csrc/flash_attention.cu`` (and ``_flash_kernel``)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    off = sk - sq if q_offset < 0 else q_offset
    scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, g, sq, d)
    qpos = off + torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hkv, g, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, d), device=q.device)
    for k0 in range(0, sk, bk):
        kt, vt = k[:, :, k0:k0 + bk].float(), v[:, :, k0:k0 + bk]
        kpos = k0 + torch.arange(kt.shape[2], device=q.device)[None, :]
        ok = torch.ones((sq, kt.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt) * scale
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(),
                                         vt.float())
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).reshape(b, hq, sq, d)


def _check(q, k, v, hw_smem: int) -> None:
    """Raise with the reason on anything the CUDA kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Hq, Sq, D) and k/v (B, Hkv, Sk, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel is built for head dims {HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if smem_bytes(d, q.dtype) > hw_smem:
        raise ValueError(f"flash kernel needs {smem_bytes(d, q.dtype)} B of shared "
                         f"memory per block, the budget is {hw_smem} B")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash kernel loads rows with 16-byte loads: q/k/v base "
                         "addresses must be multiples of 16")
    if b * hq > 65535:
        raise ValueError(f"B*Hq={b * hq} exceeds the grid's 65535 blocks in y")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = -1) -> torch.Tensor:
    """Kernel wrapper: launches ``csrc/flash_attention.cu`` on a CUDA tensor
    (counting the launch in ``flash_attention.launches``), runs
    :func:`flash_attention_torch` on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel runs on CUDA tensors, got {q.device}")
    _check(q, k, v, H100.vmem_bytes)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if q_offset < 0:
        q_offset = sk - sq
    lib = _build.library("flash_attention", _bind)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, hq, hkv, sq, sk, d, int(causal), int(window),
            int(q_offset), 1.0 / (d ** 0.5), stream)
    flash_attention.launches += 1
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError_t {err}")
    return out


flash_attention.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                                    + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention.restype = ctypes.c_int

