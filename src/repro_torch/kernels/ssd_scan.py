"""Mamba-2 SSD scan: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/ssd_scan.py`` (``ssd_scan``, body ``_ssd_kernel``):
the state-space-duality form of the Mamba-2 recurrence. The sequence is cut
into chunks; within a chunk the output is a masked matrix product, across
chunks a float32 ``(P, N)`` state per (batch row, head) is carried:

- intra-chunk ``y = (C B^T o L) (dt x)`` with ``L[i, j] = exp(cum_i - cum_j)``
  for ``i >= j`` and 0 above the diagonal, masked *before* the exp (the
  masked entries are positive and overflow);
- inter-chunk ``y += exp(cum_i) C_i state^T``;
- state update ``state = exp(total) state + (dt x exp(total - cum))^T B``;
- plus the skip ``d x``; the state starts at zero.

``cum`` is the within-chunk inclusive prefix sum of ``dt * a``. Both the
kernel and the plain version keep it in float64: under strong decay it
reaches thousands, where a float32 difference ``cum_i - cum_j`` would carry
an absolute error of ~5e-4 whatever its size (a relative error of the same
size in every ``L`` entry near the diagonal). The differences are rounded to
float32 before the exp, so everything else is float32 arithmetic.

- :func:`ssd_scan` is the kernel wrapper, the custom op
  ``repro_torch::ssd_scan`` (:func:`work` counts a call's FLOPs and bytes):
  on a CUDA tensor it launches ``csrc/ssd_scan.cu`` (raising on anything
  the kernel does not take): a Gram pass writes ``G = C B^T`` once per (row, chunk) into float32
  scratch, then the chunk walk runs the per-head products on the tensor
  cores in 3xTF32; one wrapper call, counted once, issues both launches.
  On a CPU tensor it runs the plain version.
- :func:`ssd_scan_torch` is the plain version: the same chunked algorithm
  as a Python loop over chunks.
- :func:`ssd_scan_tf32x3_torch` models the kernel's decomposition and
  rounding (tests only): ``G`` once per (row, chunk), ``W = (G o L) dt``,
  and every product's operands split into TF32 hi and lo parts.
- Training: :func:`ssd_scan_train` (custom op ``repro_torch::ssd_scan_train``)
  is the same kernel also writing each chunk's starting state, ``(y,
  states)``; its registered gradient is :func:`ssd_scan_bwd` (custom op
  ``repro_torch::ssd_scan_bwd``), hand-written backward kernels in
  ``csrc/ssd_scan.cu`` (the Gram pass, a walk over the chunks that carries
  only the state gradient, a chunk-parallel pass forming every gradient on
  the tensor cores, the fixed-order sums); :func:`ssd_scan_train_torch` and
  :func:`ssd_scan_bwd_torch` are their plain versions.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
from torch.profiler import record_function

from repro_torch.hw import H100, H100_SMS, sm_count
from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, tf32_round, tf32_truncate

# largest chunk the kernel holds in shared memory (the reference's default)
MAX_CHUNK = 64
# (P, N) -> the P tiles (columns per walk block) the kernel is instantiated
# for (mamba2-1.3b and its -smoke variant), widest first. A tile of 64 runs
# 16 warps and one of 32 or 16 runs 8, with the same tiles per warp.
P_TILES = {(64, 128): (64, 32), (16, 16): (16,)}
# ring stages of the walk (csrc/ssd_scan.cu STAGES)
STAGES = 2

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(p: int, n: int, dtype: torch.dtype, pt: int) -> int:
    """Dynamic shared memory one walk block takes at head dim ``p``, state
    ``n``, input ``dtype`` and P tile ``pt`` (csrc/ssd_scan.cu
    ``Walk::BYTES``): the per-chunk vectors (cumsum in float64, dt,
    exp(cum), dt exp(total - cum), exp(total); two buffers), the float32
    state tile, and ``STAGES`` ring stages of the chunk's G (float32), x, C
    and B tiles in the input dtype, rows padded."""
    item = 2 if dtype == torch.bfloat16 else 4
    ch = MAX_CHUNK
    stage = 4 * ch * (ch + 4) + item * ch * ((pt + 8) + (n + 16 // item) + (n + 8))
    return 2 * ch * 8 + 3 * 2 * ch * 4 + 16 + 4 * pt * (n + 4) + STAGES * stage


def p_tile(bsz: int, h: int, p: int, n: int, dtype: torch.dtype, sm_count: int) -> int:
    """The walk's P tile: the widest whose block fits the shared memory and
    whose grid, one block per (P tile, head, row), still gives every SM a
    block; else the narrowest (the (1, 1024) bucket: 64 heads, two 32-column
    tiles each, 128 blocks). Float32's full-P block does not fit."""
    tiles = P_TILES[(p, n)]
    for pt in tiles:
        if (smem_bytes(p, n, dtype, pt) <= H100.vmem_bytes
                and bsz * h * (p // pt) >= sm_count):
            return pt
    return tiles[-1]


def ssd_scan_torch(x, dt, a, b_mat, c_mat, d, *, chunk: int = MAX_CHUNK) -> torch.Tensor:
    """Plain version: x (B, S, H, P), dt (B, S, H) float32, a (H,) float32
    (negative), b_mat/c_mat (B, S, N), d (H,) float32 -> y (B, S, H, P) in
    x's dtype. Every product is taken in float32 on float32 copies of the
    inputs, so bfloat16 inputs give an unrounded float32 result when passed
    as float32."""
    return _ssd_chunks(x, dt, a, b_mat, c_mat, d, chunk, keep_states=False)[0]


def ssd_scan_train_torch(x, dt, a, b_mat, c_mat, d, *,
                         chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the training forward: ``(y, states)``, y as
    :func:`ssd_scan_torch`'s and ``states`` (B, H, S / chunk, P, N) float32
    the state entering each chunk (zeros for the first), which the backward
    starts each chunk's local gradients from."""
    return _ssd_chunks(x, dt, a, b_mat, c_mat, d, chunk, keep_states=True)


def _ssd_chunks(x, dt, a, b_mat, c_mat, d, chunk, keep_states):
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}")
    dev = x.device
    af = a.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=dev)
    states = (torch.empty(states_shape(bsz, s, h, p, n, chunk), dtype=torch.float32,
                          device=dev) if keep_states else None)
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=dev)
    for t0 in range(0, s, chunk):
        if keep_states:
            states[:, :, t0 // chunk] = state
        xc = x[:, t0:t0 + chunk].float()                         # (B, c, H, P)
        dtc = dt[:, t0:t0 + chunk].float()                       # (B, c, H)
        bc = b_mat[:, t0:t0 + chunk].float()                     # (B, c, N)
        cc = c_mat[:, t0:t0 + chunk].float()
        cum = torch.cumsum((dtc * af).double(), dim=1)           # (B, c, H)
        total = cum[:, -1:]                                      # (B, 1, H)
        li = (cum[:, :, None, :] - cum[:, None, :, :]).float()   # (B, c, c, H)
        lmat = torch.exp(torch.where(tri[None, :, :, None], li,
                                     torch.full((), NEG_INF, device=dev)))
        scores = torch.matmul(cc, bc.transpose(1, 2))            # (B, c, c)
        dx = dtc[..., None] * xc                                 # (B, c, H, P)
        w = (scores[..., None] * lmat).permute(0, 3, 1, 2)       # (B, H, c, c)
        y_intra = torch.matmul(w, dx.permute(0, 2, 1, 3))        # (B, H, c, P)
        y_inter = torch.matmul(cc[:, None], state.transpose(2, 3))
        y_inter = y_inter * torch.exp(cum.float()).permute(0, 2, 1)[..., None]
        decay_to_end = torch.exp((total - cum).float())          # (B, c, H)
        contrib = torch.matmul((dx * decay_to_end[..., None]).permute(0, 2, 3, 1),
                               bc[:, None])                      # (B, H, P, N)
        state = torch.exp(total.float())[:, 0, :, None, None] * state + contrib
        y[:, t0:t0 + chunk] = (y_intra + y_inter).permute(0, 2, 1, 3)
    y = y + d.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), states


def ssd_scan_bwd_torch(x, dt, a, b_mat, c_mat, d, states, dy, *,
                       chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward, in the kernel's order: the gradient of
    :func:`ssd_scan_torch` at (x, dt, a, b_mat, c_mat, d) for the output
    gradient ``dy``, from the forward's chunk ``states``. Returns ``(dx,
    ddt, da, db_mat, dc_mat, dd)``: dx, db_mat and dc_mat in the inputs'
    dtype (formed in float32, rounded once), the rest float32.

    Three steps, each vectorised over (row, head, chunk):

    1. each chunk's increment of the state gradient, ``U_c = sum_i
       exp(cum_i) dy_i C_i^T`` (P x N);
    2. the one serial recurrence, over chunks from the last, from zero
       past it: ``dS_out[c - 1] = exp(total_c) dS_out[c] + U_c``, where
       dS_out[c] is the gradient of the state chunk c hands on;
    3. every gradient of a chunk from its starting state S and its dS_out.
       With ``G = C B^T``, ``L`` masked before the exp, ``D = dy x^T``,
       ``A1 = L o dt_j o D``, ``M = G o L o dt_j``, ``K = G o L o D``,
       ``sc_j = dt_j exp(total - cum_j)`` and ``rb_j = dS_out B_j``:

       - dx_j = sum_i M_ij dy_i + sc_j rb_j + d dy_j;
       - dB_j = (sum_h A1)^T C + sum_h sc_j dS_out^T x_j (A1 summed over
         heads before its product, as the kernel does per head group);
       - dC_i = (sum_h A1) B + sum_h exp(cum_i) S^T dy_i;
       - ddt_j = sum_i K_ij + exp(total - cum_j) x_j . rb_j + a * sum_{k >=
         j} dcum_k, the reverse cumsum taken in float64 over dcum_k = sum_j
         dt_j K_kj - dt_k sum_i K_ik + exp(cum_k) C_k . (S^T dy_k) - sc_k
         x_k . rb_k, and at the chunk's last position also exp(total)
         <dS_out, S> + sum_j sc_j x_j . rb_j;
       - da = sum dt_j * (that reverse cumsum); dd = sum x . dy.
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    dev = x.device
    af = a.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    below = torch.tril(torch.ones((chunk, chunk), device=dev), diagonal=-1)
    xf, dyf = x.float(), dy.float()

    def by_chunk(t):   # (B, S, H, ...) -> (B, H, nc, c, ...)
        t = t.reshape(bsz, nc, chunk, h, *t.shape[3:])
        return t.permute(0, 3, 1, 2, *range(4, t.dim()))

    def to_seq(t):     # (B, H, nc, c, ...) -> (B, S, H, ...)
        t = t.permute(0, 2, 3, 1, *range(4, t.dim()))
        return t.reshape(bsz, s, h, *t.shape[4:]).contiguous()

    xc, dyc, dtc = by_chunk(xf), by_chunk(dyf), by_chunk(dt.float())   # (B, H, nc, c[, P])
    bc = b_mat.float().reshape(bsz, 1, nc, chunk, n)                    # (B, 1, nc, c, N)
    cc = c_mat.float().reshape(bsz, 1, nc, chunk, n)
    cum = torch.cumsum((dtc * af[None, :, None, None]).double(), dim=-1)   # (B, H, nc, c)
    total = cum[..., -1:]
    li = (cum[..., :, None] - cum[..., None, :]).float()                   # (B, H, nc, c, c)
    lmat = torch.exp(torch.where(tri, li, torch.full((), NEG_INF, device=dev)))
    ec = torch.exp(cum.float())
    dec = torch.exp((total - cum).float())
    sc = dtc * dec
    et = torch.exp(total.float())                                          # (B, H, nc, 1)

    # 1-2: the increments, then the scan of dS_out over the chunks
    u = torch.matmul((ec[..., None] * dyc).transpose(-1, -2), cc)          # (B, H, nc, P, N)
    ds = torch.empty_like(u)
    r = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=dev)
    for ci in reversed(range(nc)):
        ds[:, :, ci] = r
        r = et[:, :, ci, :, None] * r + u[:, :, ci]
    del u

    # 3: each chunk's gradients from its S and dS_out
    g = torch.matmul(cc, bc.transpose(-1, -2))                             # (B, 1, nc, c, c)
    dmat = torch.matmul(dyc, xc.transpose(-1, -2))                         # D_ij = dy_i . x_j
    a1 = lmat * dtc[..., None, :] * dmat
    m = g * lmat * dtc[..., None, :]
    k = g * lmat * dmat
    rb = torch.matmul(bc, ds.transpose(-1, -2))                            # (B, H, nc, c, P)
    dx = (torch.matmul(m.transpose(-1, -2), dyc) + sc[..., None] * rb
          + d.float()[None, :, None, None, None] * dyc)
    a1h = a1.sum(1)                                                        # (B, nc, c, c)
    db = (torch.matmul(a1h.transpose(-1, -2), cc[:, 0])
          + (sc[..., None] * torch.matmul(xc, ds)).sum(1))                 # (B, nc, c, N)
    sdy = torch.matmul(dyc, states)                                        # (S^T dy_i)
    dc = torch.matmul(a1h, bc[:, 0]) + (ec[..., None] * sdy).sum(1)
    xrb = (xc * rb).sum(-1)                                                # (B, H, nc, c)
    ci_dot = (cc * sdy).sum(-1)
    usc = sc * xrb
    # K's diagonal cancels from cum's gradient (L_ii = 1): the sums run
    # strictly below it, in float64, or under strong decay the two sums
    # cancel to a float32 rounding error of theirs (~1e-3 of da)
    ks = (k * below).double()
    col = ks.sum(-2)
    dcum = (torch.matmul(ks, dtc.double()[..., None])[..., 0] - dtc.double() * col
            + (ec * ci_dot).double() - usc.double())
    dcum[..., -1] += (et[..., 0] * (ds * states).sum((-1, -2)) + usc.sum(-1)).double()
    rc = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = (col.float() + torch.diagonal(k, dim1=-2, dim2=-1) + dec * xrb
           + af[None, :, None, None] * rc.float())
    da = (dtc.double() * rc).sum((0, 2, 3))
    dd = (xf * dyf).sum((0, 1, 3))
    return (to_seq(dx).to(x.dtype), to_seq(ddt), da.float(),
            db.reshape(b_mat.shape).to(b_mat.dtype), dc.reshape(c_mat.shape).to(c_mat.dtype), dd)


def ssd_scan_tf32x3_torch(x, dt, a, b_mat, c_mat, d, *, chunk: int = MAX_CHUNK,
                          terms: int = 3) -> torch.Tensor:
    """The kernel's decomposition and rounding, float32 out (tests only).
    Per (row, chunk) ``G = C B^T`` once; per head ``W = (G o L) * dt_j``
    (float64 cumsum, mask before the exp), ``y = W x + exp(cum) (C
    state^T) + d x`` and ``state = exp(total) state + (x sc)^T B`` with
    ``sc = dt exp(total - cum)``. Every product splits both operands as hi
    = tf32(v) (rounded), lo = v - hi (read as TF32, truncated) and sums
    hi.hi + (hi.lo + lo.hi) in float32; an operand exact in TF32 (a
    bfloat16 input) has lo = 0. ``terms=1`` keeps hi.hi alone."""
    def mm(u, v):
        u_hi, v_hi = tf32_round(u), tf32_round(v)
        out = u_hi @ v_hi
        if terms == 3:
            out = out + (u_hi @ tf32_truncate(v - v_hi) + tf32_truncate(u - u_hi) @ v_hi)
        return out

    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}")
    dev = x.device
    xf, bf, cf, dtf, af = x.float(), b_mat.float(), c_mat.float(), dt.float(), a.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=dev)
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=dev)
    for t0 in range(0, s, chunk):
        xc = xf[:, t0:t0 + chunk]                                # (B, c, H, P)
        dtc = dtf[:, t0:t0 + chunk]                              # (B, c, H)
        bc, cc = bf[:, t0:t0 + chunk], cf[:, t0:t0 + chunk]      # (B, c, N)
        g = mm(cc, bc.transpose(1, 2))                           # (B, c, c), once per chunk
        cum = torch.cumsum((dtc * af).double(), dim=1)           # (B, c, H)
        total = cum[:, -1:]
        li = (cum[:, :, None, :] - cum[:, None, :, :]).float()   # (B, c, c, H)
        lmat = torch.exp(torch.where(tri[None, :, :, None], li,
                                     torch.full((), NEG_INF, device=dev)))
        w = (g[..., None] * lmat * dtc[:, None, :, :]).permute(0, 3, 1, 2)  # (B, H, c, c)
        y_intra = mm(w, xc.permute(0, 2, 1, 3))                  # (B, H, c, P)
        y_inter = mm(cc[:, None], state.transpose(2, 3))         # (B, H, c, P)
        ec = torch.exp(cum.float()).permute(0, 2, 1)[..., None]  # (B, H, c, 1)
        sc = dtc * torch.exp((total - cum).float())              # (B, c, H)
        upd = mm((xc * sc[..., None]).permute(0, 2, 3, 1), bc[:, None])   # (B, H, P, N)
        state = torch.exp(total.float())[:, 0, :, None, None] * state + upd
        y[:, t0:t0 + chunk] = (y_intra + ec * y_inter).permute(0, 2, 1, 3)
    return y + d.float()[None, None, :, None] * xf


def _check(x, dt, a, b_mat, c_mat, d, chunk: int, sm_count: int = H100_SMS) -> int:
    """Raise with the reason on anything the CUDA kernel does not take;
    return the walk's P tile on a card of ``sm_count`` SMs."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1] if b_mat.dim() == 3 else -1
    want = {"dt": (bsz, s, h), "a": (h,), "b_mat": (bsz, s, n), "c_mat": (bsz, s, n),
            "d": (h,)}
    for name, t in (("dt", dt), ("a", a), ("b_mat", b_mat), ("c_mat", c_mat), ("d", d)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]} for x {tuple(x.shape)}, "
                             f"got {tuple(t.shape)}")
    if x.dtype not in _DTYPES or b_mat.dtype != x.dtype or c_mat.dtype != x.dtype:
        raise TypeError(f"ssd kernel takes float32 or bfloat16 x/b_mat/c_mat of one "
                        f"dtype, got {x.dtype}, {b_mat.dtype}, {c_mat.dtype}")
    for name, t in (("dt", dt), ("a", a), ("d", d)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd kernel takes float32 {name}, got {t.dtype}")
    if (p, n) not in P_TILES:
        raise ValueError(f"ssd kernel is built for (P, N) in {sorted(P_TILES)}, "
                         f"got ({p}, {n})")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"ssd kernel needs 1 <= chunk <= {MAX_CHUNK} and S % chunk "
                         f"== 0, got S={s}, chunk={chunk}")
    pt = p_tile(bsz, h, p, n, x.dtype, sm_count)
    if smem_bytes(p, n, x.dtype, pt) > H100.vmem_bytes:
        raise ValueError(f"ssd kernel needs {smem_bytes(p, n, x.dtype, pt)} B of shared memory "
                         f"per block at P tile {pt}, the budget is {H100.vmem_bytes} B")
    if h > 65535 or bsz > 65535:
        raise ValueError(f"H={h} and B={bsz} must each fit the grid's 65535 blocks")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b_mat", b_mat), ("c_mat", c_mat),
                    ("d", d)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, b_mat, c_mat)):
        raise ValueError("ssd kernel loads rows with 16-byte loads: x/b_mat/c_mat "
                         "base addresses must be multiples of 16")
    return pt


def work(x, dt, a, b_mat, c_mat, d, chunk: int = MAX_CHUNK) -> _build.Work:
    """FLOPs and bytes of one call: C B^T once per (row, chunk) and, per
    (row, head, chunk), the masked score product, the inter-chunk product
    and the state update; each input read once and y written once."""
    b, s, h, p = x.shape
    n = b_mat.shape[-1]
    chunk = min(chunk, s)
    nc = s // chunk
    flops = b * nc * 2 * chunk * chunk * n + b * h * nc * (2 * chunk * chunk * p
                                                           + 4 * chunk * n * p)
    nbytes = (2 * x.numel() * x.element_size() + dt.numel() * 4
              + 2 * b_mat.numel() * b_mat.element_size() + 2 * h * 4)
    return _build.Work(flops, nbytes)


def _run(x, dt, a, b_mat, c_mat, d, chunk, states):
    """The Gram pass and the chunk walk; with ``states`` (B, H, S / chunk,
    P, N) float32 the walk also writes the state entering each chunk."""
    pt = _check(x, dt, a, b_mat, c_mat, d, chunk, sm_count(x.device))
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    lib = _build.library("ssd_scan", _bind)
    y = torch.empty_like(x)
    # C B^T per (row, chunk), written by the Gram pass and read by the walk
    g = torch.empty((bsz, s // chunk, MAX_CHUNK, MAX_CHUNK), dtype=torch.float32,
                    device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
                           c_mat.data_ptr(), d.data_ptr(), g.data_ptr(), y.data_ptr(),
                           states.data_ptr() if states is not None else None,
                           _DTYPES[x.dtype], bsz, s, h, p, n, pt, chunk, stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: cudaError_t {err}")
    return y


def _launch(x, dt, a, b_mat, c_mat, d, chunk):
    """CUDA implementation of ``repro_torch::ssd_scan``, counted once in
    ``ssd_scan.launches``."""
    y = _run(x, dt, a, b_mat, c_mat, d, min(chunk, x.shape[1]), None)
    ssd_scan.launches += 1
    return y


def _fake(x, dt, a, b_mat, c_mat, d, chunk):
    return torch.empty_like(x)


@_build.kernel_op("ssd_scan", work, _launch, _fake)
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
            c_mat: torch.Tensor, d: torch.Tensor, chunk: int) -> torch.Tensor:
    return ssd_scan_torch(x, dt, a, b_mat, c_mat, d, chunk=chunk)


@_build.counted
def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
             c_mat: torch.Tensor, d: torch.Tensor, *, chunk: int = MAX_CHUNK) -> torch.Tensor:
    """Kernel wrapper: the custom op ``repro_torch::ssd_scan``, which
    launches ``csrc/ssd_scan.cu`` on a CUDA tensor and runs
    :func:`ssd_scan_torch` on a CPU tensor. ``chunk`` is capped at S."""
    _build.require_cpu_or_cuda(x, "ssd kernel")
    return _ssd_op(x, dt, a, b_mat, c_mat, d, chunk)


# -- training: the forward that keeps each chunk's state, and the backward --

def states_shape(bsz: int, s: int, h: int, p: int, n: int,
                 chunk: int = MAX_CHUNK) -> Tuple[int, ...]:
    """Shape of the float32 chunk states the training forward keeps for the
    backward: the state entering each chunk, (B, H, S / chunk, P, N)."""
    return (bsz, h, s // min(chunk, s), p, n)


def heads_per_block(bsz: int, s: int, h: int, chunk: int = MAX_CHUNK,
                    sms: int = H100_SMS) -> int:
    """Heads one block of the backward's chunk pass takes in order (a head
    group): halving from all H, the most that still give ``BWD_WAVES``
    blocks an SM, one block per (chunk, row, head group). 16 at Mamba-2
    1.3B's training shape (4, 2048, 64 heads): 512 blocks on 132 SMs."""
    blocks = bsz * (s // min(chunk, s))
    hpb = h
    while hpb > 1 and blocks * -(-h // hpb) < BWD_WAVES * sms:
        hpb = -(-hpb // 2)
    return hpb


def bwd_scratch(bsz: int, s: int, h: int, p: int, n: int, chunk: int = MAX_CHUNK,
                sms: int = H100_SMS) -> Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]:
    """(shape, dtype) of each scratch tensor one backward call allocates:
    the Gram matrices C B^T (B, S / chunk, 64, 64); each chunk's dS_out
    (B, H, S / chunk, P, N); the head groups' dB and dC partials (B, groups,
    S, N) each, all float32; the per-(row, chunk, head) da partials in
    float64 and dd partials in float32."""
    nc = s // min(chunk, s)
    groups = -(-h // heads_per_block(bsz, s, h, chunk, sms))
    f32 = torch.float32
    return (((bsz, nc, MAX_CHUNK, MAX_CHUNK), f32), ((bsz, h, nc, p, n), f32),
            ((bsz, groups, s, n), f32), ((bsz, groups, s, n), f32),
            ((bsz, nc, h), torch.float64), ((bsz, nc, h), f32))


def train_bytes(bsz: int, s: int, h: int, p: int, n: int,
                chunk: int = MAX_CHUNK) -> Tuple[int, int]:
    """(saved, scratch): bytes of the chunk states one training forward
    keeps for the backward, and of one backward call's scratch."""
    scratch = sum(math.prod(sh) * dt.itemsize
                  for sh, dt in bwd_scratch(bsz, s, h, p, n, chunk))
    return 4 * math.prod(states_shape(bsz, s, h, p, n, chunk)), scratch


def work_train(x, dt, a, b_mat, c_mat, d, chunk: int = MAX_CHUNK) -> _build.Work:
    """:func:`work` plus the chunk states written, (B, H, S / chunk, P, N)
    float32."""
    b, s, h, p = x.shape
    w = work(x, dt, a, b_mat, c_mat, d, chunk)
    saved, _ = train_bytes(b, s, h, p, b_mat.shape[-1], chunk)
    return _build.Work(w.flops, w.bytes + saved)


def work_bwd(x, dt, a, b_mat, c_mat, d, states, dy, chunk: int = MAX_CHUNK) -> _build.Work:
    """FLOPs and bytes of one backward call: C B^T once per (row, chunk)
    and, per (row, head, chunk), the products D = dy x^T and the dx, dB,
    dC and dS terms (each (c, c, P), (c, c, N) or (c, P, N)); x, dy, B, C,
    dt and the chunk states read once, dx, ddt, dB and dC written once."""
    b, s, h, p = x.shape
    n = b_mat.shape[-1]
    chunk = min(chunk, s)
    nc = s // chunk
    flops = b * nc * 2 * chunk * chunk * n + b * h * nc * (
        2 * 2 * chunk * chunk * p + 2 * 2 * chunk * chunk * n + 4 * 2 * chunk * p * n)
    item = x.element_size()
    nbytes = (3 * x.numel() * item + 2 * dt.numel() * 4 + 4 * b_mat.numel() * item
              + states.numel() * 4 + 4 * h * 4)
    return _build.Work(flops, nbytes)


def _check_bwd(x, dt, a, b_mat, c_mat, d, states, dy, chunk: int) -> None:
    """Raise with the reason on anything the backward kernel does not take
    (besides the forward's limits, :func:`_check`)."""
    _check(x, dt, a, b_mat, c_mat, d, chunk)
    bsz, s, h, p = x.shape
    want = states_shape(bsz, s, h, p, b_mat.shape[-1], chunk)
    if tuple(states.shape) != want or states.dtype != torch.float32:
        raise ValueError(f"states must be float32 {want}, got {states.dtype} "
                         f"{tuple(states.shape)}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    for name, t in (("states", states), ("dy", dy)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    need = bwd_smem_bytes(p, b_mat.shape[-1], x.dtype)
    if need > H100.vmem_bytes:
        raise ValueError(f"ssd backward needs {need} B of shared memory per block, the "
                         f"budget is {H100.vmem_bytes} B")


def bwd_smem_bytes(p: int, n: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the backward's chunk pass
    (csrc/ssd_scan.cu ``BwdChunk::BYTES``): three float64 vectors (the
    cumsum, K's row and column sums), the float vectors and row partials,
    G, M and K (c x c float32, rows padded by 8), B and C (c x N) and x and
    dy (c x P) in the input dtype (rows padded by 16 bytes), S and dS_out
    (P x N float32, rows padded by 4)."""
    item = 2 if dtype == torch.bfloat16 else 4
    ch, nw = MAX_CHUNK, BWD_WARPS[(p, n)]
    fvec = -(-(4 * ch + 2 * ch * (nw // 4) + 2 * nw + 4) * 4 // 16) * 16
    return (3 * ch * 8 + fvec + 3 * 4 * ch * (ch + 8) + 2 * item * ch * (n + 16 // item)
            + 2 * item * ch * (p + 16 // item) + 2 * 4 * p * (n + 4))


# warps of a chunk-pass block per (P, N) (csrc/ssd_scan.cu: 16 at the full
# width, 8 at the smoke width)
BWD_WARPS = {(64, 128): 16, (16, 16): 8}
# blocks an SM the chunk pass's head groups aim at (heads_per_block)
BWD_WAVES = 3
# the backward's span in a torch.profiler trace
BACKWARD_SPAN = "ssd_scan.backward"


def _launch_train(x, dt, a, b_mat, c_mat, d, chunk):
    """CUDA implementation of ``repro_torch::ssd_scan_train``: the forward
    kernel writing each chunk's starting state, counted in
    ``ssd_scan_train.launches``."""
    chunk = min(chunk, x.shape[1])
    bsz, s, h, p = x.shape
    states = torch.empty(states_shape(bsz, s, h, p, b_mat.shape[-1], chunk),
                         dtype=torch.float32, device=x.device)
    y = _run(x, dt, a, b_mat, c_mat, d, chunk, states)
    ssd_scan_train.launches += 1
    return y, states


def _fake_train(x, dt, a, b_mat, c_mat, d, chunk):
    bsz, s, h, p = x.shape
    return torch.empty_like(x), x.new_empty(states_shape(bsz, s, h, p, b_mat.shape[-1], chunk),
                                            dtype=torch.float32)


def _launch_bwd(x, dt, a, b_mat, c_mat, d, states, dy, chunk):
    """CUDA implementation of ``repro_torch::ssd_scan_bwd``: the Gram pass,
    the dS walk, the chunk pass (per head group dB and dC partials) and the
    fixed-order sums over groups and (row, chunk), counted once in
    ``ssd_scan_bwd.launches``."""
    chunk = min(chunk, x.shape[1])
    _check_bwd(x, dt, a, b_mat, c_mat, d, states, dy, chunk)
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    sms = sm_count(x.device)
    hpb = heads_per_block(bsz, s, h, chunk, sms)
    lib = _build.library("ssd_scan", _bind)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, db, dc = torch.empty_like(x), torch.empty_like(b_mat), torch.empty_like(c_mat)
    ddt, da, dd = torch.empty_like(dt), torch.empty((h,), **f32), torch.empty((h,), **f32)
    # the Gram matrices, each chunk's dS_out, the groups' dB and dC partials,
    # the (row, chunk, head) da and dd partials
    g, dso, dbp, dcp, dap, ddp = (torch.empty(sh, dtype=dtype, device=x.device)
                                  for sh, dtype in bwd_scratch(bsz, s, h, p, n, chunk, sms))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            d.data_ptr(), states.data_ptr(), dy.data_ptr(), g.data_ptr(), dso.data_ptr(),
            dbp.data_ptr(), dcp.data_ptr(), dap.data_ptr(), ddp.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(), dd.data_ptr(),
            _DTYPES[x.dtype], bsz, s, h, p, n, chunk, hpb, stream)
    ssd_scan_bwd.launches += 1
    if err:
        raise RuntimeError(f"ssd_scan_bwd launch failed: cudaError_t {err}")
    return dx, ddt, da, db, dc, dd


def _fake_bwd(x, dt, a, b_mat, c_mat, d, states, dy, chunk):
    return (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(a),
            torch.empty_like(b_mat), torch.empty_like(c_mat), torch.empty_like(d))


@_build.kernel_op("ssd_scan_train", work_train, _launch_train, _fake_train)
def _ssd_train_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                  c_mat: torch.Tensor, d: torch.Tensor,
                  chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return ssd_scan_train_torch(x, dt, a, b_mat, c_mat, d, chunk=chunk)


@_build.kernel_op("ssd_scan_bwd", work_bwd, _launch_bwd, _fake_bwd)
def _ssd_bwd_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor, d: torch.Tensor, states: torch.Tensor, dy: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    return ssd_scan_bwd_torch(x, dt, a, b_mat, c_mat, d, states, dy, chunk=chunk)


def _train_setup(ctx, inputs, output) -> None:
    x, dt, a, b_mat, c_mat, d, chunk = inputs
    ctx.save_for_backward(x, dt, a, b_mat, c_mat, d, output[1])
    ctx.chunk = chunk
    ctx.mark_non_differentiable(output[1])


def _train_backward(ctx, dy, _dstates):
    with record_function(BACKWARD_SPAN):
        grads = ssd_scan_bwd(*ctx.saved_tensors, dy.contiguous(), chunk=ctx.chunk)
    return (*grads, None)


_ssd_train_op.register_autograd(_train_backward, setup_context=_train_setup)


@_build.counted
def ssd_scan_train(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, d: torch.Tensor, *,
                   chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of the training forward: the custom op
    ``repro_torch::ssd_scan_train``, ``(y, states)`` — on a CUDA tensor one
    call of ``csrc/ssd_scan.cu`` that also writes each chunk's starting
    state, on a CPU tensor :func:`ssd_scan_train_torch`. Its gradient is
    :func:`ssd_scan_bwd` on either device."""
    _build.require_cpu_or_cuda(x, "ssd kernel")
    return _ssd_train_op(x, dt, a, b_mat, c_mat, d, chunk)


@_build.counted
def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                 c_mat: torch.Tensor, d: torch.Tensor, states: torch.Tensor, dy: torch.Tensor,
                 *, chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, ...]:
    """Kernel wrapper of the backward: the custom op
    ``repro_torch::ssd_scan_bwd``, ``(dx, ddt, da, db_mat, dc_mat, dd)`` —
    on a CUDA tensor the backward kernel of ``csrc/ssd_scan.cu``, on a CPU
    tensor :func:`ssd_scan_bwd_torch`."""
    _build.require_cpu_or_cuda(x, "ssd kernel")
    return _ssd_bwd_op(x, dt, a, b_mat, c_mat, d, states, dy, chunk)


def _bind(lib: ctypes.CDLL) -> None:
    lib.ssd_scan.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.ssd_scan.restype = ctypes.c_int
    lib.ssd_scan_bwd.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.ssd_scan_bwd.restype = ctypes.c_int
