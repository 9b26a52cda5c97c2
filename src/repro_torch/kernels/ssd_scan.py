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

- :func:`ssd_scan` is the kernel wrapper: on a CUDA tensor it launches
  ``csrc/ssd_scan.cu`` (raising on anything the kernel does not take), on
  a CPU tensor it runs the plain version.
- :func:`ssd_scan_torch` is the plain version: the same chunked algorithm
  as a Python loop over chunks.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.hw import H100
from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF

# largest chunk the kernel holds in shared memory (the reference's default)
MAX_CHUNK = 64
# (P, N) -> P columns per block: the (P, N) the kernel is instantiated for
# (mamba2-1.3b and its -smoke variant); a P of 64 splits into two blocks
P_TILES = {(64, 128): 32, (16, 16): 16}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(p: int, n: int) -> int:
    """Dynamic shared memory one block takes at head dim ``p``, state ``n``:
    the chunk's cumsum (float64), C and B rows, the x tile, the masked score
    tile, the state tile and four per-position vectors, in float32 with
    padded rows (csrc/ssd_scan.cu ``smem_bytes``)."""
    pt = P_TILES[(p, n)]
    ch = MAX_CHUNK
    floats = (2 * ch + 2 * ch * (n + 4) + ch * (pt + 4) + ch * (ch + 4)
              + pt * (n + 4) + 3 * ch + 4)
    return 4 * floats


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


def _check(x, dt, a, b_mat, c_mat, d, chunk: int) -> None:
    """Raise with the reason on anything the CUDA kernel does not take."""
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
    if smem_bytes(p, n) > H100.vmem_bytes:
        raise ValueError(f"ssd kernel needs {smem_bytes(p, n)} B of shared memory "
                         f"per block, the budget is {H100.vmem_bytes} B")
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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
             c_mat: torch.Tensor, d: torch.Tensor, *, chunk: int = MAX_CHUNK) -> torch.Tensor:
    """Kernel wrapper: launches ``csrc/ssd_scan.cu`` on a CUDA tensor
    (counting the launch in ``ssd_scan.launches``), runs
    :func:`ssd_scan_torch` on a CPU tensor. ``chunk`` is capped at S."""
    if x.device.type == "cpu":
        return ssd_scan_torch(x, dt, a, b_mat, c_mat, d, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd kernel runs on CUDA tensors, got {x.device}")
    chunk = min(chunk, x.shape[1])
    _check(x, dt, a, b_mat, c_mat, d, chunk)
    bsz, s, h, p = x.shape
    lib = _build.library("ssd_scan", _bind)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
                           c_mat.data_ptr(), d.data_ptr(), y.data_ptr(), _DTYPES[x.dtype],
                           bsz, s, h, p, b_mat.shape[-1], chunk, stream)
    ssd_scan.launches += 1
    if err:
        raise RuntimeError(f"ssd_scan launch failed: cudaError_t {err}")
    return y


ssd_scan.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.ssd_scan.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.ssd_scan.restype = ctypes.c_int
