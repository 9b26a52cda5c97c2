"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/flash_attention.py``: GQA through ``bh // g``,
causal and/or sliding-window masks (``kpos > qpos - window``), ``q_offset``
(-1 means ``Sk - Sq``), an online softmax in float32 and fully-masked rows
giving zeros. K/V come in kv-head form ``(B, Hkv, Sk, D)``: the GQA
expansion is never materialized.

- :func:`flash_attention` is the kernel wrapper, the custom op
  ``repro_torch::flash_attention``: on a CUDA tensor it launches
  ``csrc/flash_attention.cu`` (raising on anything the kernel does not
  take), on a CPU tensor it runs the plain version; :func:`work` counts a
  call's FLOPs and bytes. Unlike the TPU
  kernel it pads nothing: the ragged ``Sk`` tail is masked per element, so
  unaligned bidirectional attention needs no special case. bfloat16 at
  D = 64, 128 and 256 runs ``flash_wgmma_kernel<D>`` (TMA + wgmma; 128-key
  tiles at D = 128, 64-key tiles at D = 64, two blocks an SM, and at
  D = 256), at D = 32
  ``flash_mma_kernel`` (mma.sync, 64-key tiles; only smoke configurations
  have D = 32); float32 runs ``flash_tf32x3_kernel<D>`` (3xTF32 on mma.sync,
  8 warps, 128-row query tiles and 64-key tiles; at D = 256 64-row tiles,
  each row group's keys and columns over two warps). Key tiles
  wholly outside the causal and window masks are skipped, not masked.
- :func:`flash_attention_torch` is the plain version: the same masks
  applied to the full score matrix (``kernels/ref.py::attention_ref`` with
  the kernel's ``q_offset`` convention).
- :func:`flash_attention_train` is the training forward, the custom op
  ``repro_torch::flash_attention_train``: the same kernel, which then also
  writes each row's log-sum-exp of its scaled scores (``lse``, float32,
  -1e30 for a row with no unmasked key), returning ``(out, lse)``. Its
  gradient is :func:`flash_attention_bwd`: the kernel of
  ``csrc/flash_attention_bwd.cu`` on a CUDA tensor, the reference's
  recompute rule (``_blocked``'s custom VJP, ``repro/models/attention.py``)
  as plain PyTorch, :func:`attention_bwd_torch`, on a CPU tensor. Its CPU
  implementation is :func:`flash_attention_train_torch`, the reference's
  ``_blocked_fwd_impl`` (online softmax over KV chunks of ``KV_CHUNK``).
  The serving op keeps its schema and writes no ``lse``.
- :func:`flash_attention_bwd` is the backward's kernel wrapper, the custom
  op ``repro_torch::flash_attention_bwd``, ``(dq, dk, dv)`` from ``(q, k,
  v, out, lse, dout)``: on a CUDA tensor one call of
  ``csrc/flash_attention_bwd.cu`` (delta, then the dK/dV pass over key
  tiles and the dQ pass over query tiles, sums in a fixed order; bfloat16
  at D = 64, 128 and 256 on TMA + wgmma (64 keys or query rows a consumer
  warpgroup, two a block at D = 128, three at D = 64; at D = 256 one
  64-key tile a block with the output columns split between its two
  consumers and each kv head's query heads over :func:`bwd_kv_splits`
  blocks), at D = 32 on mma.sync; float32 in 3xTF32 on mma.sync, 8 warps
  a block, each kv head's query heads over :func:`bwd_kv_splits` blocks
  where the dK/dV pass's blocks are few;
  :func:`bwd_kernel_names` names the passes a call runs), on a CPU tensor
  :func:`attention_bwd_torch`; :func:`work_bwd` counts its five products
  and its bytes, :func:`bwd_smem_bytes` its shared memory.
  :func:`attention_bwd_tiled` is its plain version in the kernel's order
  and rounding (P and dS rounded to the inputs' dtype before they feed a
  product, dQ summed over :func:`bwd_key_tile` keys a tile), returning
  float32.
- :func:`flash_decode` is the one-row kernel wrapper, the custom op
  ``repro_torch::flash_decode``: q ``(B, Hq, D)``, one query row a batch
  row, against K/V in the model's own ``(B, Sk, Hkv, D)`` layout, read in
  place through their strides (no transpose, no copy), with the same
  ``causal``, ``window`` and ``q_offset``. On a CUDA tensor it launches
  ``flash_decode_kernel`` (one block per kv head, split of the keys and
  batch row, :func:`decode_splits` sizing the splits to the card; float32
  on the CUDA cores, the g <= 16 query heads of a kv head together; the
  last split of each (row, kv head) to finish merges the splits' partials);
  on a CPU tensor its plain version :func:`flash_decode_torch`. A decode tick's cross read takes it
  (``models/attention.py``).
- :func:`flash_attention_tiled` is the plain version in the bfloat16
  kernels' own order and rounding (:func:`key_tile` keys per tile, a
  running max, exp2 of the scores times ``scale * log2(e)``, P rounded to
  V's dtype before P.V), returning float32: in bfloat16 the kernel's output
  is then within its own rounding (half a bfloat16 ulp) of it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.hw import H100, sm_count
from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, attention_ref

# head dims csrc/flash_attention.cu is instantiated for
HEAD_DIMS = (32, 64, 128, 256)
# query rows and keys per tile of flash_mma_kernel (bfloat16, D = 32)
BQ, BK = 64, 64
# flash_tf32x3_kernel<D> (float32, csrc/flash_attention.cu ff::Shape<D>):
# per head dim (query rows a block, keys a tile, K/V ring stages, parts):
# 8 warps of 16 rows; at D = 256 64 rows, each row group's keys and output
# columns divided between two warps, which exchange each row's max and sum
TF32X3_TILES = {32: (128, 64, 2, 1), 64: (128, 64, 2, 1), 128: (128, 64, 2, 1),
                256: (64, 64, 1, 2)}
# flash_wgmma_kernel<D> (bfloat16, D = 64, 128 and 256): 128-row query
# tiles; per head dim, (keys per tile, K/V ring stages): at D = 256 a
# consumer's 64 x 256 float32 output takes 128 registers a thread, which
# leaves room for a 64-key tile's scores only, and two 32 KB K/V stages
# beside the 64 KB Q tile fill an SM's shared memory; at D = 64 two blocks
# share an SM (csrc/flash_attention.cu, Shape<64>), each with 64-key tiles
# in two stages and at most 112 registers a thread
WGMMA_BQ = 128
WGMMA_TILES = {64: (64, 2), 128: (128, 3), 256: (64, 2)}
# flash_decode (one query row a batch row): the blocks an SM the key splits
# aim for (a block's 48 KB ring at D = 64 lets four share an SM), the
# fewest keys a split takes, the most query heads a kv head may serve
DECODE_BLOCKS_PER_SM = 4
DECODE_MIN_SPLIT = 64
DECODE_MAX_G = 16
# flash_decode's count of finished splits per (batch row, kv head): zero
# between launches (the last split resets it), one buffer per card that is
# never freed, so that a captured CUDA graph's pointer to it stays valid
DECODE_MAX_PAIRS = 1 << 16
_COUNTERS: Dict[int, torch.Tensor] = {}
LOG2E = 1.4426950408889634
# flash_wgmma_kernel<64> moves a row's running max (of the scores times
# scale * log2(e)) only when a tile's passes it by more than this, so most
# tiles leave the row's output unscaled and p stays below 2^8 (kSlack)
RESCALE_SLACK = {64: 8.0}
# keys per chunk of the plain training forward and of the recompute backward
# (the reference's models/attention.py KV_CHUNK)
KV_CHUNK = 1024
# the backward's span in a torch.profiler trace
BACKWARD_SPAN = "attention.backward"
# csrc/flash_attention_bwd.cu, bfloat16 at D = 64, 128 and 256 (TMA +
# wgmma, hb::Shape<D>): the dK/dV pass's (keys a block, query rows a tile,
# ring stages; 64 keys a block: the two consumers split the output columns)
# and the dQ pass's (query rows a block, keys a tile, ring depth)
BWD_WGMMA_DKDV = {64: (192, 64, 3), 128: (128, 64, 2), 256: (64, 64, 2)}
BWD_WGMMA_DQ = {64: (192, 64, 3), 128: (128, 64, 2), 256: (128, 64, 3)}
# head dims whose dQ ring holds a K or a V tile a slot (its depth counts
# tiles), not a stage of both
BWD_DQ_APART = frozenset({256})
# head dims whose bfloat16 dK/dV pass divides each kv head's query heads
# over up to this many blocks (float32 partials, summed in split order)
# where its blocks would not fill the card BWD_KV_WAVES times over; the
# float32 pass may divide them over up to g blocks at every head dim
BWD_KV_SPLITS = {256: 2}
BWD_KV_WAVES = 2
# bfloat16 at D = 32 (mma.sync): keys a dK/dV block, query rows a dQ block
# and keys a dQ tile
BWD_BLOCK = 64
# float32 (3xTF32 on mma.sync, f3::Shape<D>): keys a tile of the dQ pass
# at every head dim, over which dQ is summed in ascending order; the dK/dV
# pass's (keys a block, query rows a tile, ring stages) and the dQ pass's
# (query rows a block, keys a tile, ring stages)
BWD_FP32_KEYS = 64
BWD_FP32_DKDV = {32: (128, 64, 2), 64: (128, 64, 2), 128: (64, 64, 2), 256: (32, 64, 1)}
BWD_FP32_DQ = {32: (128, BWD_FP32_KEYS, 2), 64: (128, BWD_FP32_KEYS, 2),
               128: (128, BWD_FP32_KEYS, 1), 256: (32, BWD_FP32_KEYS, 1)}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def key_tile(d: int) -> int:
    """Keys per tile of the bfloat16 kernel at head dim d: 128 for
    flash_wgmma_kernel<128>, 64 for flash_wgmma_kernel<64> and <256> and
    for flash_mma_kernel (D = 32)."""
    return WGMMA_TILES[d][0] if d in WGMMA_TILES else BK


def bwd_key_tile(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Keys per tile of the backward's dQ pass at head dim d, over which dQ
    is summed in ascending order: in bfloat16 the TMA + wgmma pass's at D =
    64, 128 and 256 (``BWD_WGMMA_DQ``), the mma.sync pass's (``BWD_BLOCK``)
    at D = 32; in float32 the 3xTF32 pass's (``BWD_FP32_KEYS``); 64 at
    every head dim in both as built."""
    if dtype == torch.float32:
        return BWD_FP32_KEYS
    return BWD_WGMMA_DQ[d][1] if d in BWD_WGMMA_DQ else BWD_BLOCK


def bwd_kv_splits(b: int, hq: int, hkv: int, sk: int, d: int, dtype: torch.dtype,
                  sms: int) -> int:
    """The blocks over which the dK/dV pass divides each kv head's query
    heads on a card of ``sms`` SMs: 1 unless the head dim and dtype allow
    more (``BWD_KV_SPLITS`` in bfloat16; in float32 at every head dim) and
    its ``b * hkv * ceil(sk / keys a block)`` blocks would not fill the
    card ``BWD_KV_WAVES`` times over; then as many as that needs, at most
    the cap and the g query heads, and of those as few as give a split no
    more query heads (``ceil(g / splits)``, the longest split's share). Each
    split's blocks write float32 partials of dK and dV that a fourth launch
    sums in split order, so a shape always gets the same splits and the
    same bits."""
    g = hq // hkv
    if dtype == torch.float32:
        cap, keys = g, BWD_FP32_DKDV[d][0]
    else:
        cap, keys = min(BWD_KV_SPLITS.get(d, 1), g), BWD_WGMMA_DKDV.get(d, (BWD_BLOCK,))[0]
    blocks = b * hkv * -(-sk // keys)
    if cap <= 1 or blocks == 0 or blocks >= BWD_KV_WAVES * sms:
        return 1
    return -(-g // -(-g // min(cap, -(-BWD_KV_WAVES * sms // blocks))))


def bwd_kernel_names(d: int, dtype: torch.dtype) -> Tuple[str, str]:
    """The dK/dV and dQ kernels of ``csrc/flash_attention_bwd.cu`` that a
    backward call at head dim d in dtype runs (the C entry point dispatches
    on both; the delta pass and, with splits, the partials' sum beside
    them): float32 the 3xTF32 passes at every head dim, bfloat16 the TMA +
    wgmma passes at D = 64, 128 and 256 and the mma.sync ones at D = 32."""
    if dtype == torch.float32:
        return f"flash_bwd_dkdv_tf32x3_kernel<{d}>", f"flash_bwd_dq_tf32x3_kernel<{d}>"
    if d in BWD_WGMMA_DKDV:
        return f"flash_bwd_dkdv_wgmma_kernel<{d}>", f"flash_bwd_dq_wgmma_kernel<{d}>"
    return f"flash_bwd_dkdv_mma_kernel<{d}>", f"flash_bwd_dq_mma_kernel<{d}>"


def bwd_smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the backward's larger pass at head dim d.
    bfloat16 at D = 64, 128 and 256: the dK/dV pass holds its K and V
    tiles, and per ring stage a Q and a dO tile and the rows' lse and delta
    (float32); the dQ pass holds its Q and dO tiles and per stage a K and a
    V tile (``BWD_DQ_APART``: per slot one of them); each adds its
    mbarriers (one, and a full and an empty one per stage or slot) and 1 KB
    to align the tiles to the 128-byte swizzle's period. bfloat16 at D = 32:
    tiles of padded rows (D + 8) of K, V, Q and dO (dK/dV pass, with the
    tile's lse and delta) or of Q, dO, K and V (dQ pass). float32: tiles of
    rows of D floats (swizzled, unpadded): K and V, per ring stage Q and dO
    with the rows' lse and delta, and P^T and dS^T (dK/dV pass, ``keys x
    rows``); or Q and dO, per stage K and V, and dS (dQ pass)."""
    if dtype == torch.bfloat16 and d in BWD_WGMMA_DKDV:
        bn, bm, stages = BWD_WGMMA_DKDV[d]
        dkdv = 1024 + 2 * bn * d * 2 + stages * (2 * bm * d * 2 + 2 * bm * 4) + 8 * (1 + 2 * stages)
        bm, bn, stages = BWD_WGMMA_DQ[d]
        tiles = stages if d in BWD_DQ_APART else 2 * stages
        dq = 1024 + 2 * bm * d * 2 + tiles * bn * d * 2 + 8 * (1 + 2 * stages)
        return max(dkdv, dq)
    if dtype == torch.bfloat16:   # 64-row query tiles in the dK/dV pass
        blk = BWD_BLOCK
        return max(4 * blk * (d + 8) * 2 + 2 * blk * 4, 4 * blk * (d + 8) * 2)
    bn, bm, stages = BWD_FP32_DKDV[d]
    dkdv = 4 * (2 * bn * d + stages * (2 * bm * d + 2 * bm) + 2 * bn * bm)
    bm, bn, stages = BWD_FP32_DQ[d]
    dq = 4 * (2 * bm * d + stages * 2 * bn * d + bm * bn)
    return max(dkdv, dq)


def smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory one block of the kernel takes at head dim d.
    bfloat16 at D = 64, 128 and 256: the Q tile, a K and a V tile per ring
    stage, the mbarriers and 1 KB to align the tiles to the 128-byte
    swizzle's period; at D = 32: Q, K and V tiles of padded bf16 rows.
    float32: the Q tile (128 rows, 64 at D = 256), a K and a V tile per
    ring stage and the P tile (the Q tile's rows of a key tile), float32
    rows of D (or the key tile's) floats, swizzled, unpadded; at D = 256
    also each row's max and sum from each of its two warps."""
    if dtype == torch.bfloat16 and d in WGMMA_TILES:
        bk, stages = WGMMA_TILES[d]
        q_tile, kv_tile = WGMMA_BQ * d * 2, bk * d * 2
        return 1024 + q_tile + 2 * stages * kv_tile + 8 * (1 + 4 * stages)
    if dtype == torch.bfloat16:
        return 3 * BQ * (d + 8) * 2
    bm, bk, stages, parts = TF32X3_TILES[d]
    stats = 2 * parts * bm if parts > 1 else 0
    return 4 * (bm * d + stages * 2 * bk * d + bm * bk + stats)


def kernel_name(d: int, dtype: torch.dtype) -> str:
    """The kernel of ``csrc/flash_attention.cu`` that a call at head dim d
    in dtype runs (the C entry point dispatches on both)."""
    if dtype == torch.float32:
        return f"flash_tf32x3_kernel<{d}>"
    return f"flash_wgmma_kernel<{d}>" if d in WGMMA_TILES else "flash_mma_kernel"


def exp2_scale(d: int) -> float:
    """``scale * log2(e)`` as the bfloat16 kernels compute it: the float32
    product of the float32 scale and the float32 log2(e)."""
    c = np.float32(np.float32(1.0 / (d ** 0.5)) * np.float32(LOG2E))
    return float(c)  # lint: allow-tracer-host-sync (a numpy scalar)


def flash_attention_torch(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = -1) -> torch.Tensor:
    """Plain version: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D)."""
    return attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=None if q_offset < 0 else q_offset)


def flash_attention_tiled(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = -1, bk: int | None = None,
                          slack: float | None = None) -> torch.Tensor:
    """Plain version in the bfloat16 kernels' order: q (B, Hq, Sq, D), k/v
    (B, Hkv, Sk, D) -> float32 (B, Hq, Sq, D), unrounded.

    Keys are visited in tiles of ``bk`` (default :func:`key_tile`). Each
    row keeps the running max of its scores times ``c = scale * log2(e)``
    (``ms``; it moves only where a tile's passes it by more than ``slack``,
    default :data:`RESCALE_SLACK` for the head dim, else 0) and its
    denominator in float32; a tile's unscaled scores s give
    ``p = exp2(s * c - ms)``, the exponent rounded once as the kernel's fused
    multiply-add rounds it, and P is rounded to V's dtype before the P.V
    product, as in ``csrc/flash_attention.cu``. ``_flash_kernel`` computes
    the same function with exp of pre-scaled scores."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    bk = key_tile(d) if bk is None else bk
    slack = RESCALE_SLACK.get(d, 0.0) if slack is None else slack
    off = sk - sq if q_offset < 0 else q_offset
    c = exp2_scale(d)
    qf = q.float().reshape(b, hkv, g, sq, d)
    qpos = off + torch.arange(sq, device=q.device)[:, None]
    ms = torch.full((b, hkv, g, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(ms)
    acc = torch.zeros((b, hkv, g, sq, d), device=q.device)
    for k0 in range(0, sk, bk):
        kt, vt = k[:, :, k0:k0 + bk].float(), v[:, :, k0:k0 + bk]
        kpos = k0 + torch.arange(kt.shape[2], device=q.device)[None, :]
        ok = torch.ones((sq, kt.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt)
        s = torch.where(ok, s, NEG_INF)
        ms_new = torch.maximum(ms, s.amax(-1, keepdim=True) * c)
        ms_new = torch.where(ms_new > ms + slack, ms_new, ms)
        # s * c is exact in float64, so one rounding to float32 follows
        arg = (s.double() * c - ms_new.double()).float()
        p = torch.where(ok, torch.exp2(arg), 0.0)
        alpha = torch.exp2(ms - ms_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(),
                                         vt.float())
        ms = ms_new
    return (acc / torch.where(l == 0, 1.0, l)).reshape(b, hq, sq, d)


def _chunk_mask(qpos, k0, n, sk, causal, window):
    """(Sq, n) keys k0 .. k0 + n - 1 each query position sees."""
    kpos = k0 + torch.arange(n, device=qpos.device)[None, :]
    msk = kpos < sk
    if causal:
        msk = msk & (kpos <= qpos[:, None])
    if window > 0:
        msk = msk & (kpos > qpos[:, None] - window)
    return msk.expand(qpos.shape[0], n)


def flash_attention_train_torch(q, k, v, *, causal: bool = True, window: int = 0,
                                q_offset: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain training forward, the reference's ``_blocked_fwd_impl``: q (B,
    Hq, Sq, D), k/v (B, Hkv, Sk, D) -> (out in q's dtype, lse (B, Hq, Sq)
    float32). An online softmax in float32 over chunks of ``KV_CHUNK``
    keys, each GQA group's queries against its kv head (no expansion);
    ``lse`` is the log-sum-exp of the scaled scores, -1e30 for a row with
    no unmasked key (whose output is zero)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    off = sk - sq if q_offset < 0 else q_offset
    chunk = min(KV_CHUNK, sk)
    qf = (q.float() * (d ** -0.5)).reshape(b, hkv, g * sq, d)
    qpos = off + torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, device=q.device)
    l_sum = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), device=q.device)
    for k0 in range(0, sk, chunk):
        kb, vb = k[:, :, k0:k0 + chunk].float(), v[:, :, k0:k0 + chunk].float()
        msk = _chunk_mask(qpos, k0, kb.shape[2], sk, causal, window)
        s = torch.matmul(qf, kb.transpose(-1, -2)).reshape(b, hkv, g, sq, -1)
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l_sum = alpha * l_sum + p.sum(-1)
        pv = torch.matmul(p.reshape(b, hkv, g * sq, -1), vb).reshape(b, hkv, g, sq, d)
        acc = alpha[..., None] * acc + pv
        m = m_new
    l_safe = torch.where(l_sum == 0, 1.0, l_sum)
    out = (acc / l_safe[..., None]).reshape(b, hq, sq, d).to(q.dtype)
    lse = torch.where(l_sum == 0, NEG_INF, m + torch.log(l_safe)).reshape(b, hq, sq)
    return out, lse


def attention_bwd_torch(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                        q_offset: int = -1) -> Tuple[torch.Tensor, ...]:
    """The reference's recompute backward (``_blocked_bwd``): the gradients
    of ``(q, k, v)`` from the forward's ``out`` and ``lse`` and the output's
    gradient, all in the kernel's layout (q, out, dout (B, Hq, Sq, D), k/v
    (B, Hkv, Sk, D), lse (B, Hq, Sq)). Per chunk of ``KV_CHUNK`` keys, in
    float32: ``p = exp(q.k * scale - lse)`` masked, ``delta = sum(dout *
    out)``, ``ds = p * (dout.v - delta) * scale``; dk and dv are summed over
    each GQA group's query heads, so K/V are never expanded. Returns (dq,
    dk, dv) in q's, k's and v's dtypes."""
    with record_function(BACKWARD_SPAN):
        return _attention_bwd(q, k, v, out, lse, dout, causal, window, q_offset)


def _attention_bwd(q, k, v, out, lse, dout, causal, window, q_offset):
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    off = sk - sq if q_offset < 0 else q_offset
    chunk = min(KV_CHUNK, sk)
    scale = d ** -0.5
    qf = q.float().reshape(b, hkv, g * sq, d)
    doutf = dout.float().reshape(b, hkv, g * sq, d)
    delta = (doutf * out.float().reshape(b, hkv, g * sq, d)).sum(-1)
    lse_r = lse.reshape(b, hkv, g * sq, 1)
    qpos = off + torch.arange(sq, device=q.device)
    dq = torch.zeros_like(qf)
    dk = torch.empty((b, hkv, sk, d), device=q.device)
    dv = torch.empty((b, hkv, sk, d), device=q.device)
    for k0 in range(0, sk, chunk):
        kb, vb = k[:, :, k0:k0 + chunk].float(), v[:, :, k0:k0 + chunk].float()
        n = kb.shape[2]
        msk = _chunk_mask(qpos, k0, n, sk, causal, window).repeat(g, 1)   # (g Sq, n)
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        p = torch.where(msk, torch.exp(s - lse_r), 0.0)
        dv[:, :, k0:k0 + n] = torch.matmul(p.transpose(-1, -2), doutf)
        dp = torch.matmul(doutf, vb.transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.matmul(ds, kb)
        dk[:, :, k0:k0 + n] = torch.matmul(ds.transpose(-1, -2), qf)
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def attention_bwd_tiled(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                        q_offset: int = -1) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`flash_attention_bwd` in the kernel's order
    and rounding, the same arguments -> float32 (dq, dk, dv), unrounded.

    P is recomputed in the exp2 domain, ``p = exp2(s * c - lse * log2(e))``
    with ``c = scale * log2(e)``, the exponent rounded once as the kernel's
    fused multiply-add rounds it; ``delta = sum(dout * out)`` and ``ds = p *
    (dp - delta) * scale`` in float32. P and dS are rounded to the inputs'
    dtype where they feed a product (dV += P^T.dO, dK += dS^T.Q, dQ += dS.K),
    as the bfloat16 kernel rounds them (in float32 nothing is rounded). dQ
    sums over the key tiles of the kernel's dQ pass in ascending order
    (:func:`bwd_key_tile` keys, 64 at every head dim in both dtypes).
    dK and dV are float32 sums over each kv
    head's query heads whose order (over :func:`bwd_kv_splits` blocks or
    one) is not modelled: it moves them by float32 rounding only."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    bk = bwd_key_tile(d, q.dtype)
    off = sk - sq if q_offset < 0 else q_offset
    c = exp2_scale(d)
    scale = float(np.float32(1.0 / (d ** 0.5)))  # lint: allow-tracer-host-sync (a numpy scalar)

    def rnd(t):
        return t.to(q.dtype).float()

    qf = q.float().reshape(b, hkv, g, sq, d)
    dof = dout.float().reshape(b, hkv, g, sq, d)
    delta = (dof * out.float().reshape(b, hkv, g, sq, d)).sum(-1, keepdim=True)
    lse2 = (lse.float() * np.float32(LOG2E)).reshape(b, hkv, g, sq, 1)
    qpos = off + torch.arange(sq, device=q.device)[:, None]
    dq = torch.zeros((b, hkv, g, sq, d), device=q.device)
    dk = torch.zeros((b, hkv, sk, d), device=q.device)
    dv = torch.zeros((b, hkv, sk, d), device=q.device)
    for k0 in range(0, sk, bk):
        kt, vt = k[:, :, k0:k0 + bk].float(), v[:, :, k0:k0 + bk].float()
        kpos = k0 + torch.arange(kt.shape[2], device=q.device)[None, :]
        ok = torch.ones((sq, kt.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt)
        arg = (s.double() * c - lse2.double()).float()
        p = torch.where(ok, torch.exp2(arg), 0.0)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vt)
        ds = p * (dp - delta) * scale
        dv[:, :, k0:k0 + bk] = torch.einsum("bhgqk,bhgqd->bhkd", rnd(p), dof)
        dk[:, :, k0:k0 + bk] = torch.einsum("bhgqk,bhgqd->bhkd", rnd(ds), qf)
        dq += torch.einsum("bhgqk,bhkd->bhgqd", rnd(ds), kt)
    return dq.reshape(b, hq, sq, d), dk, dv


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


def unmasked_pairs(sq: int, sk: int, causal: bool, window: int, q_offset: int) -> int:
    """(query, key) pairs the causal and window masks leave, per (row, head)."""
    off = sk - sq if q_offset < 0 else q_offset
    qpos = off + np.arange(sq)
    hi = np.minimum(sk - 1, qpos) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros(sq, np.int64)
    pairs = np.maximum(0, hi - lo + 1).sum()
    return int(pairs)  # lint: allow-tracer-host-sync (a numpy scalar)


def work(q, k, v, causal: bool, window: int, q_offset: int) -> _build.Work:
    """FLOPs and bytes of one call: ``q.k`` and ``p.v`` over the unmasked
    pairs of every (row, query head); q, K and V read once, the output
    written once."""
    b, hq, sq, d = q.shape
    pairs = unmasked_pairs(sq, k.shape[2], causal, window, q_offset)
    return _build.Work(4 * d * pairs * b * hq,
                       (2 * q.numel() + 2 * k.numel()) * q.element_size())


def work_train(q, k, v, causal: bool, window: int, q_offset: int) -> _build.Work:
    """:func:`work` plus the float32 ``lse`` written once a row."""
    flops, nbytes = work(q, k, v, causal, window, q_offset)
    return _build.Work(flops, nbytes + 4 * q.shape[0] * q.shape[1] * q.shape[2])


def work_bwd(q, k, v, out, lse, dout, causal: bool, window: int,
             q_offset: int) -> _build.Work:
    """FLOPs and bytes of one backward call: five products (S = Q.K^T, dP =
    dO.V^T, dV, dK and dQ) of ``2 D`` FLOPs per unmasked pair of every (row,
    query head), whatever the kernel recomputes; q, k, v, out, dout and the
    float32 lse read once, dq, dk and dv written once."""
    b, hq, sq, d = q.shape
    pairs = unmasked_pairs(sq, k.shape[2], causal, window, q_offset)
    return _build.Work(5 * 2 * d * pairs * b * hq,
                       4 * (q.numel() + k.numel()) * q.element_size()
                       + lse.numel() * lse.element_size())


def _check_bwd(q, k, v, out, lse, dout, hw_smem: int = H100.vmem_bytes) -> None:
    """Raise with the reason on anything the backward kernel does not take:
    q/k/v as the forward's :func:`_check` takes them, out/lse/dout beside
    them, and a pass's shared memory (:func:`bwd_smem_bytes`) past the
    per-block budget ``hw_smem``."""
    _check(q, k, v, H100.vmem_bytes)
    need = bwd_smem_bytes(q.shape[-1], q.dtype)
    if need > hw_smem:
        raise ValueError(f"flash backward kernel needs {need} B of shared memory per block, "
                         f"the budget is {hw_smem} B")
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)} and dtype {q.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])}, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    for name, t in (("out", out), ("lse", lse), ("dout", dout)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"the backward kernel loads rows with 16-byte loads: {name}'s "
                             f"base address must be a multiple of 16")


def _run(q, k, v, causal, window, q_offset, lse) -> torch.Tensor:
    """One launch of ``csrc/flash_attention.cu``: the output, and each row's
    log-sum-exp into ``lse`` unless it is None."""
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
            None if lse is None else lse.data_ptr(),
            _DTYPES[q.dtype], b, hq, hkv, sq, sk, d, causal, window, q_offset,
            1.0 / (d ** 0.5), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError_t {err}")
    return out


def _launch(q, k, v, causal, window, q_offset):
    """CUDA implementation of ``repro_torch::flash_attention``, counted in
    ``flash_attention.launches``."""
    out = _run(q, k, v, causal, window, q_offset, None)
    flash_attention.launches += 1
    return out


def _launch_train(q, k, v, causal, window, q_offset):
    """CUDA implementation of ``repro_torch::flash_attention_train``,
    counted in ``flash_attention_train.launches``."""
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    out = _run(q, k, v, causal, window, q_offset, lse)
    flash_attention_train.launches += 1
    return out, lse


def _fake(q, k, v, causal, window, q_offset):
    return torch.empty_like(q)


def _fake_train(q, k, v, causal, window, q_offset):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@_build.kernel_op("flash_attention", work, _launch, _fake)
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: int, q_offset: int) -> torch.Tensor:
    return flash_attention_torch(q, k, v, causal=causal, window=window, q_offset=q_offset)


@_build.counted
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = -1) -> torch.Tensor:
    """Kernel wrapper: the custom op ``repro_torch::flash_attention``, which
    launches ``csrc/flash_attention.cu`` on a CUDA tensor and runs
    :func:`flash_attention_torch` on a CPU tensor."""
    _build.require_cpu_or_cuda(q, "flash kernel")
    return _flash_op(q, k, v, causal, window, q_offset)


@_build.kernel_op("flash_attention_train", work_train, _launch_train, _fake_train)
def _flash_train_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                    window: int, q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_train_torch(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)


def _train_setup(ctx, inputs, output) -> None:
    q, k, v, causal, window, q_offset = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.mask = dict(causal=causal, window=window, q_offset=q_offset)
    ctx.mark_non_differentiable(lse)


def _train_backward(ctx, dout, _dlse):
    # the output's gradient reaches here as a view of the model's (B, Sq,
    # Hq, D) layout (models/attention.py returns out.transpose(1, 2)): the
    # kernel reads it as one contiguous copy
    q, k, v, out, lse = ctx.saved_tensors
    with record_function(BACKWARD_SPAN):
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), **ctx.mask)
    return dq, dk, dv, None, None, None


_flash_train_op.register_autograd(_train_backward, setup_context=_train_setup)


@_build.counted
def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          q_offset: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of the training forward: the custom op
    ``repro_torch::flash_attention_train``, ``(out, lse)`` — on a CUDA
    tensor one launch of ``csrc/flash_attention.cu`` that also writes
    ``lse``, on a CPU tensor :func:`flash_attention_train_torch`; its
    gradient is :func:`flash_attention_bwd`: the backward kernel on a CUDA
    tensor, the plain rule :func:`attention_bwd_torch` on a CPU tensor."""
    _build.require_cpu_or_cuda(q, "flash kernel")
    return _flash_train_op(q, k, v, causal, window, q_offset)


def _launch_bwd(q, k, v, out, lse, dout, causal, window, q_offset):
    """CUDA implementation of ``repro_torch::flash_attention_bwd``: the delta
    pass, the dK/dV pass (with :func:`bwd_kv_splits` above 1, into float32
    partials that a fourth launch sums) and the dQ pass of
    ``csrc/flash_attention_bwd.cu``, counted once in
    ``flash_attention_bwd.launches``."""
    _check_bwd(q, k, v, out, lse, dout)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if q_offset < 0:
        q_offset = sk - sq
    lib = _build.library("flash_attention_bwd", _bind_bwd)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    splits = bwd_kv_splits(b, hq, hkv, sk, d, q.dtype, sm_count(q.device))
    part = (torch.empty((2, splits, b, hkv, sk, d), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), _DTYPES[q.dtype], b, hq, hkv, sq, sk, d,
            splits, causal, window, q_offset, 1.0 / (d ** 0.5), stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError_t {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def _fake_bwd(q, k, v, out, lse, dout, causal, window, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@_build.kernel_op("flash_attention_bwd", work_bwd, _launch_bwd, _fake_bwd)
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  lse: torch.Tensor, dout: torch.Tensor, causal: bool, window: int,
                  q_offset: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return attention_bwd_torch(q, k, v, out, lse, dout, causal=causal, window=window,
                               q_offset=q_offset)


@_build.counted
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0,
                        q_offset: int = -1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper of the backward: the custom op
    ``repro_torch::flash_attention_bwd``, ``(dq, dk, dv)`` in q's, k's and
    v's dtypes from the training forward's inputs, ``out`` and ``lse`` and
    the output's gradient, all in the kernel's layout — on a CUDA tensor one
    call of ``csrc/flash_attention_bwd.cu`` (raising on anything it does not
    take), on a CPU tensor :func:`attention_bwd_torch`."""
    _build.require_cpu_or_cuda(q, "flash backward kernel")
    return _flash_bwd_op(q, k, v, out, lse, dout, causal, window, q_offset)


def decode_range(sk: int, causal: bool, window: int, q_offset: int) -> Tuple[int, int]:
    """The keys ``[lo, hi)`` that one query row at absolute position
    ``q_offset`` (-1: ``Sk - 1``) sees under the causal and window masks."""
    qpos = sk - 1 if q_offset < 0 else q_offset
    lo = max(0, qpos - window + 1) if window > 0 else 0
    hi = min(sk, qpos + 1) if causal else sk
    return lo, max(lo, hi)


def decode_splits(lo: int, hi: int, rows: int, sms: int) -> Tuple[int, int]:
    """(splits, keys a split) over ``[lo, hi)`` for ``rows`` (batch row, kv
    head) pairs on ``sms`` SMs: at most :data:`DECODE_BLOCKS_PER_SM` blocks
    an SM (one wave), no split under :data:`DECODE_MIN_SPLIT` keys, at least
    one split."""
    keys = hi - lo
    n = max(1, min(DECODE_BLOCKS_PER_SM * sms // rows, -(-keys // DECODE_MIN_SPLIT)))
    split = max(1, -(-keys // n))
    return max(1, -(-keys // split)), split


def flash_decode_torch(q, k, v, *, causal: bool = True, window: int = 0,
                       q_offset: int = -1) -> torch.Tensor:
    """Plain version of :func:`flash_decode`: q (B, Hq, D), k/v (B, Sk, Hkv,
    D) -> (B, Hq, D) in q's dtype, :func:`flash_attention_torch` at one
    query row."""
    out = attention_ref(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                        window=window, q_offset=None if q_offset < 0 else q_offset)
    return out[:, :, 0]


def work_decode(q, k, v, causal: bool, window: int, q_offset: int) -> _build.Work:
    """FLOPs and bytes of one :func:`flash_decode` call: ``q.k`` and ``p.v``
    over the keys each row sees, for every query head; those K and V rows
    and q read once, the output written once (the splits' float32 partials
    are the kernel's own traffic, not the function's)."""
    b, hq, d = q.shape
    lo, hi = decode_range(k.shape[1], causal, window, q_offset)
    keys = hi - lo
    return _build.Work(4 * d * keys * b * hq,
                       (2 * q.numel() + 2 * b * k.shape[2] * keys * d) * q.element_size())


def _check_decode(q, k, v) -> None:
    """Raise with the reason on anything flash_decode_kernel does not take."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Hq, D) and k/v (B, Sk, Hkv, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if b * hkv > DECODE_MAX_PAIRS:
        raise ValueError(f"flash_decode counts splits for at most {DECODE_MAX_PAIRS} "
                         f"(row, kv head) pairs, got {b * hkv}")
    if hq // hkv > DECODE_MAX_G:
        raise ValueError(f"flash_decode takes at most {DECODE_MAX_G} query heads a kv head, "
                         f"got {hq // hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode is built for head dims {HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode takes float32 or bfloat16 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if k.stride() != v.stride() or k.stride(3) != 1:
        raise ValueError(f"k and v must share strides with unit stride over D, got "
                         f"{k.stride()} and {v.stride()}")
    if any(t.data_ptr() % 16 for t in (q, k, v)) or any(
            (st * k.element_size()) % 16 for st in k.stride()[:3]):
        raise ValueError("flash_decode copies K/V rows in 16-byte chunks: base addresses "
                         "and row, head and batch strides must be multiples of 16 bytes")


def _decode_counters(device: torch.device) -> torch.Tensor:
    """The card's split counters (:data:`DECODE_MAX_PAIRS` int32, zero)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _COUNTERS:
        _COUNTERS[index] = torch.zeros(DECODE_MAX_PAIRS, dtype=torch.int32, device=device)
    return _COUNTERS[index]


def _launch_decode(q, k, v, causal, window, q_offset):
    """CUDA implementation of ``repro_torch::flash_decode``, counted in
    ``flash_decode.launches``: one launch, whose last split of each (row,
    kv head) merges the splits' partials."""
    _check_decode(q, k, v)
    b, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    lo, hi = decode_range(sk, causal, window, q_offset)
    n_splits, split = decode_splits(lo, hi, b * hkv, sm_count(q.device))
    part_acc = torch.empty((b, hkv, n_splits, g, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, hkv, n_splits, g, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    counters = _decode_counters(q.device)
    lib = _build.library("flash_attention", _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), counters.data_ptr(), _DTYPES[q.dtype], b, hkv, g, d,
            k.stride(0), k.stride(1), k.stride(2), lo, hi, split, n_splits, 1.0 / (d ** 0.5),
            stream)
    if err:
        raise RuntimeError(f"flash_decode launch failed: cudaError_t {err}")
    flash_decode.launches += 1
    return out


def _fake_decode(q, k, v, causal, window, q_offset):
    return torch.empty_like(q)


@_build.kernel_op("flash_decode", work_decode, _launch_decode, _fake_decode)
def _decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
               window: int, q_offset: int) -> torch.Tensor:
    return flash_decode_torch(q, k, v, causal=causal, window=window, q_offset=q_offset)


@_build.counted
def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0, q_offset: int = -1) -> torch.Tensor:
    """Kernel wrapper: the custom op ``repro_torch::flash_decode``, one query
    row a batch row (q (B, Hq, D)) against k/v (B, Sk, Hkv, D) read in
    place; on a CUDA tensor one launch of ``flash_decode_kernel``, on a
    CPU tensor :func:`flash_decode_torch`."""
    _build.require_cpu_or_cuda(q, "flash decode kernel")
    return _decode_op(q, k, v, causal, window, q_offset)


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                                    + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_decode.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
                                 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_decode.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.flash_attention_bwd.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 11
                                        + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_bwd.restype = ctypes.c_int
