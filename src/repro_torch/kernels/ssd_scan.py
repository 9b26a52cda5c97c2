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
"""

from __future__ import annotations

import ctypes

import torch

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
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}")
    dev = x.device
    af = a.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=dev)
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=dev)
    for t0 in range(0, s, chunk):
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
    return y.to(x.dtype)


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


def _launch(x, dt, a, b_mat, c_mat, d, chunk):
    """CUDA implementation of ``repro_torch::ssd_scan``: the Gram pass and
    the chunk walk, counted once in ``ssd_scan.launches``."""
    chunk = min(chunk, x.shape[1])
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
                           _DTYPES[x.dtype], bsz, s, h, p, n, pt, chunk, stream)
    ssd_scan.launches += 1
    if err:
        raise RuntimeError(f"ssd_scan launch failed: cudaError_t {err}")
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


def _bind(lib: ctypes.CDLL) -> None:
    lib.ssd_scan.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.ssd_scan.restype = ctypes.c_int
