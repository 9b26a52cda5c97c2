"""The RG-LRU recurrence of a prompt pass: the CUDA kernel's wrapper and its
plain version.

The reference runs ``h_t = a_t * h_{t-1} + b_t`` as ``lax.associative_scan``
(``repro/models/blocks.py:570``, in ``rglru_block_apply``); no Pallas kernel
computes it. Both forms here fuse the gates of ``_lru_gates`` and the
product with the gelu'd ``y`` branch around the recurrence, with the
reference's rounding points:

- inputs in the model dtype: ``xb`` (the conv output), ``r_pre`` and
  ``i_pre`` (``xb @ w_r + b_r`` and ``xb @ w_i + b_i``, the bias added in
  the model dtype) and ``y_pre`` (``h @ w_y``); ``c = -8 softplus(a_log)``
  per channel in float32;
- ``r, i = sigmoid(float(.))``, ``a = exp(c r)``,
  ``bt = sqrt(max(1 - a^2, 1e-9)) i float(xb)``, ``h`` in float32;
- ``y = (h * gelu_tanh(float(y_pre))).to(model dtype)``, and the state ``h``
  at each row's ``lengths - 1`` for the prefill -> decode handoff.

- :func:`rglru_scan` is the kernel wrapper, the custom op
  ``repro_torch::rglru_scan`` (:func:`work` counts a call's FLOPs and
  bytes): on a CUDA tensor it launches
  ``csrc/rglru_scan.cu`` (raising on anything the kernel does not take), on
  a CPU tensor it runs the plain version. The kernel scans t in chunks of
  ``SCAN_CHUNK`` positions, ``chunks`` of them side by side in a block
  (:func:`chunk_plan`): each chunk's decay product and end state, then
  every chunk from the state the chunks before it hand on. It takes the
  special functions (exp, reciprocal, rsqrt) from the hardware's
  approximations, a few float32 ulp each.
- :func:`rglru_scan_torch` is the plain version: the gates over the whole
  sequence, then a sequential float32 loop over t.
- :func:`rglru_scan_chunked_torch` is the plain version in the kernel's
  order (its chunks, its float32 association of the recurrence); the tests
  hold it to a float64 sequential loop and to the reference.
- Training: :func:`rglru_scan_train` (custom op
  ``repro_torch::rglru_scan_train``) is the same kernel also writing the
  state entering each chunk of ``SCAN_CHUNK`` positions, ``(y, h_chunks)``;
  its registered gradient is :func:`rglru_scan_bwd` (custom op
  ``repro_torch::rglru_scan_bwd``), a hand-written backward kernel in
  ``csrc/rglru_scan.cu`` (each input loaded once, the forward's special
  functions); :func:`rglru_scan_train_torch` and
  :func:`rglru_scan_bwd_torch` are their plain versions.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.profiler import record_function
import torch.nn.functional as F

from repro_torch.hw import H100_SMS, sm_count
from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's shape (csrc/rglru_scan.cu): positions per chunk (one
# thread's), chunks per block at most (16 channels x 32 chunks: 512 threads)
SCAN_CHUNK, SCAN_MAX_CHUNKS = 8, 32
# threads per SM the chunk plan aims at: a full SM (two 512-thread blocks
# of 64 registers), for loads enough in flight to cover the memory's latency
SCAN_THREADS_PER_SM = 2048
# the backward's span in a torch.profiler trace
BACKWARD_SPAN = "rglru_scan.backward"


def chunk_plan(b: int, s: int, w: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """(positions per chunk, chunks per block) of the scan kernel at
    (B, S, W). A block owns 16 channels of one row, so ``B * W / 16``
    blocks whatever the plan; its threads are one per (channel, chunk).
    Chunks per block: the fewest, a power of two, that give about
    ``SCAN_THREADS_PER_SM`` threads on each of ``sms`` SMs, at most
    ``SCAN_MAX_CHUNKS`` and no more than one tile covering S needs. On 132
    SMs at W = 2560: 16 at (8, 2048) (1,280 blocks of 256 threads), 32 at
    batch 1 (160 blocks of 512)."""
    want = -(-SCAN_THREADS_PER_SM * sms // (b * w))
    chunks = 1
    while chunks < min(want, SCAN_MAX_CHUNKS) and chunks * SCAN_CHUNK < s:
        chunks *= 2
    return SCAN_CHUNK, chunks


def lru_gates_torch(r_pre: torch.Tensor, i_pre: torch.Tensor,
                    c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(a, gate)`` in float32: the recurrence's decay and its input gate
    (``bt = gate * float(xb)``), as the reference's ``_lru_gates``."""
    r = torch.sigmoid(r_pre.float())
    i = torch.sigmoid(i_pre.float())
    a = torch.exp(c * r)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9))
    return a, beta * i


def rglru_scan_torch(xb: torch.Tensor, r_pre: torch.Tensor, i_pre: torch.Tensor,
                     y_pre: torch.Tensor, c: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (B, S, W) inputs -> ``(y, h_last)``, y in
    ``out_dtype`` (default ``xb.dtype``; float32 leaves it unrounded),
    h_last (B, W) float32 at ``clamp(lengths - 1, 0, S - 1)`` (default: the
    last position)."""
    b, s, w = xb.shape
    a, gate = lru_gates_torch(r_pre, i_pre, c)
    bt = gate * xb.float()
    yb = F.gelu(y_pre.float(), approximate="tanh")
    hseq = torch.empty((b, s, w), dtype=torch.float32, device=xb.device)
    h = torch.zeros((b, w), dtype=torch.float32, device=xb.device)
    for t in range(s):
        h = a[:, t] * h + bt[:, t]
        hseq[:, t] = h
    y = (hseq * yb).to(out_dtype or xb.dtype)
    if lengths is None:
        last = torch.full((b,), s - 1, dtype=torch.long, device=xb.device)
    else:
        last = torch.clamp(lengths.long() - 1, 0, s - 1)
    return y, hseq[torch.arange(b, device=xb.device), last]


def rglru_scan_chunked_torch(xb: torch.Tensor, r_pre: torch.Tensor, i_pre: torch.Tensor,
                             y_pre: torch.Tensor, c: torch.Tensor,
                             lengths: Optional[torch.Tensor] = None,
                             out_dtype: Optional[torch.dtype] = None, *, chunk: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version in the kernel's order (at ``chunk = SCAN_CHUNK``), for
    the tests: the same function as :func:`rglru_scan_torch`, with t cut
    into chunks of ``chunk`` positions. Each chunk's decay product A and
    its end state H from h = 0 (in order, in float32); the state entering
    chunk k is ``A[k-1] h + H[k-1]`` composed from h = 0 over the chunks
    before it; each chunk then runs again from that state."""
    b, s, w = xb.shape
    a, gate = lru_gates_torch(r_pre, i_pre, c)
    bt = gate * xb.float()
    yb = F.gelu(y_pre.float(), approximate="tanh")
    hseq = torch.empty((b, s, w), dtype=torch.float32, device=xb.device)
    h_in = torch.zeros((b, w), dtype=torch.float32, device=xb.device)
    for t0 in range(0, s, chunk):
        prod = torch.ones_like(h_in)
        end = torch.zeros_like(h_in)
        h = h_in
        for t in range(t0, min(t0 + chunk, s)):
            prod = prod * a[:, t]
            end = a[:, t] * end + bt[:, t]
            h = a[:, t] * h + bt[:, t]
            hseq[:, t] = h
        h_in = prod * h_in + end
    y = (hseq * yb).to(out_dtype or xb.dtype)
    if lengths is None:
        last = torch.full((b,), s - 1, dtype=torch.long, device=xb.device)
    else:
        last = torch.clamp(lengths.long() - 1, 0, s - 1)
    return y, hseq[torch.arange(b, device=xb.device), last]


def rglru_scan_train_torch(xb: torch.Tensor, r_pre: torch.Tensor, i_pre: torch.Tensor,
                           y_pre: torch.Tensor, c: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the training forward: ``(y, h_chunks)``, y as
    :func:`rglru_scan_torch`'s and ``h_chunks`` (B, ceil(S / SCAN_CHUNK), W)
    float32 the state entering each chunk of ``SCAN_CHUNK`` positions
    (zeros for the first), from which the backward recomputes each chunk's
    states."""
    b, s, w = xb.shape
    a, gate = lru_gates_torch(r_pre, i_pre, c)
    bt = gate * xb.float()
    yb = F.gelu(y_pre.float(), approximate="tanh")
    hseq = torch.empty((b, s, w), dtype=torch.float32, device=xb.device)
    h = torch.zeros((b, w), dtype=torch.float32, device=xb.device)
    for t in range(s):
        h = a[:, t] * h + bt[:, t]
        hseq[:, t] = h
    h_chunks = torch.zeros(states_shape(b, s, w), dtype=torch.float32, device=xb.device)
    h_chunks[:, 1:] = hseq[:, SCAN_CHUNK - 1:s - 1:SCAN_CHUNK]
    return (hseq * yb).to(xb.dtype), h_chunks


def gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the tanh-approximate gelu ``0.5 x (1 + tanh(u))``, ``u =
    sqrt(2 / pi) (x + 0.044715 x^3)``: ``0.5 (1 + tanh u) + 0.5 x (1 -
    tanh^2 u) du/dx`` (the derivative autodiff takes through JAX's
    default ``jax.nn.gelu``)."""
    k = math.sqrt(2.0 / math.pi)
    th = torch.tanh(k * (x + 0.044715 * x * x * x))
    return 0.5 * (1.0 + th) + 0.5 * x * (1.0 - th * th) * k * (1.0 + 3 * 0.044715 * x * x)


def rglru_scan_bwd_torch(xb: torch.Tensor, r_pre: torch.Tensor, i_pre: torch.Tensor,
                         y_pre: torch.Tensor, c: torch.Tensor, h_chunks: torch.Tensor,
                         dy: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward: the gradient of
    :func:`rglru_scan_train_torch`'s y for the output gradient ``dy``,
    ``(dxb, dr_pre, di_pre, dy_pre, dc)``, the first four in the inputs'
    dtype (formed in float32, rounded once), dc (W,) float32 summed over
    (B, S).

    The states are recomputed in the kernel's order: each chunk of
    ``SCAN_CHUNK`` positions from the state ``h_chunks`` hands it, so
    ``h_{t-1}`` needs no (B, S, W) buffer. Then the reverse recurrence
    ``dh_t = dy_t gelu(y_pre_t) + a_{t+1} dh_{t+1}`` (sequential here; the
    kernel composes chunks), ``da_t = dh_t h_{t-1}``, ``db_t = dh_t``, and
    through the gates: ``b = beta sigmoid(i_pre) xb``, ``beta = sqrt(max(1 -
    a^2, 1e-9))`` — whose derivative in a is ``-a / beta`` above the clamp,
    0 below it and half that at a tie, as JAX's ``maximum`` takes it (in
    float32 ``1 - a^2`` is 0 or at least 2^-24, so a tie cannot occur) —
    and ``a = exp(c sigmoid(r_pre))``."""
    b, s, w = xb.shape
    r = torch.sigmoid(r_pre.float())
    i = torch.sigmoid(i_pre.float())
    a = torch.exp(c * r)
    u = 1.0 - a * a
    beta = torch.sqrt(torch.clamp(u, min=1e-9))
    xf = xb.float()
    bt = beta * i * xf
    # h per chunk from the chunk's starting state, chunks side by side
    nck = h_chunks.shape[1]
    pad = nck * SCAN_CHUNK - s
    a_c = F.pad(a, (0, 0, 0, pad), value=1.0).view(b, nck, SCAN_CHUNK, w)
    b_c = F.pad(bt, (0, 0, 0, pad)).view(b, nck, SCAN_CHUNK, w)
    hs = torch.empty((b, nck, SCAN_CHUNK, w), dtype=torch.float32, device=xb.device)
    h = h_chunks
    for q in range(SCAN_CHUNK):
        h = a_c[:, :, q] * h + b_c[:, :, q]
        hs[:, :, q] = h
    hseq = hs.view(b, nck * SCAN_CHUNK, w)[:, :s]
    hprev = torch.empty_like(hseq)                  # h_{t-1}: each chunk's carry first
    hprev[:, 1:] = hseq[:, :-1]
    hprev[:, ::SCAN_CHUNK] = h_chunks
    yf = y_pre.float()
    e = dy.float() * F.gelu(yf, approximate="tanh")
    dh = torch.empty_like(e)
    carry = torch.zeros((b, w), dtype=torch.float32, device=xb.device)
    for t in reversed(range(s)):
        carry = e[:, t] + carry
        dh[:, t] = carry
        carry = a[:, t] * carry
    dy_pre = dy.float() * hseq * gelu_tanh_grad(yf)
    dxb = dh * beta * i
    dg = dh * xf
    di_pre = dg * beta * i * (1.0 - i)
    dbeta = torch.where(u > 1e-9, 1.0, torch.where(u == 1e-9, 0.5, 0.0)) * dg * i
    ga = dh * hprev - dbeta * a / beta
    dca = ga * a
    dc = (dca * r).sum((0, 1))
    dr_pre = dca * c * r * (1.0 - r)
    dt = xb.dtype
    return dxb.to(dt), dr_pre.to(dt), di_pre.to(dt), dy_pre.to(dt), dc


def _check(xb, r_pre, i_pre, y_pre, c, lengths, chunks: int = 1) -> None:
    """Raise with the reason on anything the CUDA kernel does not take."""
    if xb.dim() != 3:
        raise ValueError(f"xb must be (B, S, W), got {tuple(xb.shape)}")
    b, _s, w = xb.shape
    for name, t in (("r_pre", r_pre), ("i_pre", i_pre), ("y_pre", y_pre)):
        if t.shape != xb.shape or t.dtype != xb.dtype:
            raise ValueError(f"{name} must match xb {tuple(xb.shape)} {xb.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if xb.dtype not in _DTYPES:
        raise TypeError(f"rglru_scan kernel takes float32 or bfloat16 inputs, got {xb.dtype}")
    if c.dtype != torch.float32 or tuple(c.shape) != (w,):
        raise ValueError(f"c must be float32 ({w},), got {c.dtype} {tuple(c.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be int32 ({b},), got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    if b > 65535:
        raise ValueError(f"B={b} exceeds the grid's 65535 blocks in y")
    if not 1 <= chunks <= SCAN_MAX_CHUNKS:
        raise ValueError(f"chunks={chunks}: a block takes 1 to {SCAN_MAX_CHUNKS} chunks")
    for name, t in (("xb", xb), ("r_pre", r_pre), ("i_pre", i_pre), ("y_pre", y_pre),
                    ("c", c), ("lengths", lengths)):
        if t.device != xb.device:
            raise ValueError(f"{name} is on {t.device}, xb on {xb.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def work(xb, r_pre, i_pre, y_pre, c, lengths=None, chunks=None) -> _build.Work:
    """FLOPs and bytes of one call: ~26 float32 operations an element (two
    sigmoids, exp, sqrt, the tanh gelu, the products and the recurrence's
    multiply-add); the four inputs read and y written, c, the lengths and
    the float32 state."""
    b, s, w = xb.shape
    elems = b * s * w
    nbytes = 5 * xb.element_size() * elems + 4 * w + 4 * b + 4 * b * w
    return _build.Work(26 * elems, nbytes)


def _run(xb, r_pre, i_pre, y_pre, c, lengths, chunks, h_chunks):
    """One launch of the scan kernel; with ``h_chunks`` (B, ceil(S /
    SCAN_CHUNK), W) float32 it also writes the state entering each chunk."""
    b, s, w = xb.shape
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=xb.device)
    if chunks is None:
        chunks = chunk_plan(b, s, w, sm_count(xb.device))[1]
    _check(xb, r_pre, i_pre, y_pre, c, lengths, chunks)
    lib = _build.library("rglru_scan", _bind)
    y = torch.empty_like(xb)
    h_last = torch.empty((b, w), dtype=torch.float32, device=xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan(xb.data_ptr(), r_pre.data_ptr(), i_pre.data_ptr(),
                             y_pre.data_ptr(), c.data_ptr(), lengths.data_ptr(),
                             y.data_ptr(), h_last.data_ptr(),
                             h_chunks.data_ptr() if h_chunks is not None else None,
                             _DTYPES[xb.dtype], b, s, w, chunks, stream)
    if err:
        raise RuntimeError(f"rglru_scan launch failed: cudaError_t {err}")
    return y, h_last


def _launch(xb, r_pre, i_pre, y_pre, c, lengths, chunks):
    """CUDA implementation of ``repro_torch::rglru_scan``, counted in
    ``rglru_scan.launches``."""
    out = _run(xb, r_pre, i_pre, y_pre, c, lengths, chunks, None)
    rglru_scan.launches += 1
    return out


def _fake(xb, r_pre, i_pre, y_pre, c, lengths, chunks):
    return torch.empty_like(xb), xb.new_empty((xb.shape[0], xb.shape[2]),
                                              dtype=torch.float32)


@_build.kernel_op("rglru_scan", work, _launch, _fake)
def _rglru_op(xb: torch.Tensor, r_pre: torch.Tensor, i_pre: torch.Tensor,
              y_pre: torch.Tensor, c: torch.Tensor, lengths: Optional[torch.Tensor],
              chunks: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    return rglru_scan_torch(xb, r_pre, i_pre, y_pre, c, lengths)


@_build.counted
def rglru_scan(xb: torch.Tensor, r_pre: torch.Tensor, i_pre: torch.Tensor,
               y_pre: torch.Tensor, c: torch.Tensor,
               lengths: Optional[torch.Tensor] = None, *,
               chunks: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper: the custom op ``repro_torch::rglru_scan``, which
    launches ``csrc/rglru_scan.cu`` on a CUDA tensor with ``chunks`` chunks
    a block (default :func:`chunk_plan` for the card; the result does not
    depend on it) and runs :func:`rglru_scan_torch` on a CPU tensor.
    Returns ``(y, h_last)``."""
    _build.require_cpu_or_cuda(xb, "rglru_scan kernel")
    return _rglru_op(xb, r_pre, i_pre, y_pre, c, lengths, chunks)


# -- training: the forward that keeps each chunk's entering state, and the
# backward --

def states_shape(b: int, s: int, w: int) -> Tuple[int, int, int]:
    """Shape of the float32 states the training forward keeps for the
    backward: the state entering each chunk of ``SCAN_CHUNK`` positions,
    (B, ceil(S / SCAN_CHUNK), W)."""
    return (b, -(-s // SCAN_CHUNK), w)


def bwd_scratch_shape(b: int, w: int) -> Tuple[int, int]:
    """Shape of the float32 scratch one backward call allocates: dc per
    row, (B, W), summed over rows in order afterwards."""
    return (b, w)


def train_bytes(b: int, s: int, w: int) -> Tuple[int, int]:
    """(saved, scratch): bytes of the states one training forward keeps for
    the backward, and of one backward call's scratch."""
    return 4 * math.prod(states_shape(b, s, w)), 4 * math.prod(bwd_scratch_shape(b, w))

def work_bwd(xb, r_pre, i_pre, y_pre, c, h_chunks, dy) -> _build.Work:
    """FLOPs and bytes of one backward call: ~60 float32 operations an
    element (the gates and gelu again, the chunk's states from its carry,
    the reverse recurrence, the gates' derivatives); the five inputs read
    and four gradients written in the model dtype, the chunk states read
    once, c read and dc written."""
    b, s, w = xb.shape
    elems = b * s * w
    nbytes = 9 * xb.element_size() * elems + 4 * h_chunks.numel() + 8 * w
    return _build.Work(60 * elems, nbytes)


def work_train(xb, r_pre, i_pre, y_pre, c) -> _build.Work:
    """:func:`work` plus the chunk states written."""
    b, s, w = xb.shape
    fw = work(xb, r_pre, i_pre, y_pre, c)
    return _build.Work(fw.flops, fw.bytes + train_bytes(b, s, w)[0])


def _launch_train(xb, r_pre, i_pre, y_pre, c):
    """CUDA implementation of ``repro_torch::rglru_scan_train``: the scan
    kernel also writing each chunk's entering state, counted in
    ``rglru_scan_train.launches``."""
    h_chunks = torch.empty(states_shape(*xb.shape), dtype=torch.float32, device=xb.device)
    y, _ = _run(xb, r_pre, i_pre, y_pre, c, None, None, h_chunks)
    rglru_scan_train.launches += 1
    return y, h_chunks


def _fake_train(xb, r_pre, i_pre, y_pre, c):
    return torch.empty_like(xb), xb.new_empty(states_shape(*xb.shape), dtype=torch.float32)


def _check_bwd(xb, r_pre, i_pre, y_pre, c, h_chunks, dy) -> None:
    """Raise with the reason on anything the backward kernel does not take
    (besides the forward's limits)."""
    b, s, w = xb.shape
    _check(xb, r_pre, i_pre, y_pre, c, torch.zeros((b,), dtype=torch.int32, device=xb.device))
    want = states_shape(b, s, w)
    if tuple(h_chunks.shape) != want or h_chunks.dtype != torch.float32:
        raise ValueError(f"h_chunks must be float32 {want}, got {h_chunks.dtype} "
                         f"{tuple(h_chunks.shape)}")
    if dy.shape != xb.shape or dy.dtype != xb.dtype:
        raise ValueError(f"dy must match xb {tuple(xb.shape)} {xb.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    for name, t in (("h_chunks", h_chunks), ("dy", dy)):
        if t.device != xb.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {xb.device}")


def _launch_bwd(xb, r_pre, i_pre, y_pre, c, h_chunks, dy):
    """CUDA implementation of ``repro_torch::rglru_scan_bwd``: the reverse
    scan (per-row dc partials), then their fixed-order sum over rows,
    counted once in ``rglru_scan_bwd.launches``."""
    _check_bwd(xb, r_pre, i_pre, y_pre, c, h_chunks, dy)
    b, s, w = xb.shape
    chunks = chunk_plan(b, s, w, sm_count(xb.device))[1]
    lib = _build.library("rglru_scan", _bind)
    dxb, dr, di, dyp = (torch.empty_like(xb) for _ in range(4))
    dc_rows = torch.empty(bwd_scratch_shape(b, w), dtype=torch.float32, device=xb.device)
    dc = torch.empty((w,), dtype=torch.float32, device=xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan_bwd(xb.data_ptr(), r_pre.data_ptr(), i_pre.data_ptr(),
                                 y_pre.data_ptr(), c.data_ptr(), h_chunks.data_ptr(),
                                 dy.data_ptr(), dxb.data_ptr(), dr.data_ptr(), di.data_ptr(),
                                 dyp.data_ptr(), dc_rows.data_ptr(), dc.data_ptr(),
                                 _DTYPES[xb.dtype], b, s, w, chunks, stream)
    rglru_scan_bwd.launches += 1
    if err:
        raise RuntimeError(f"rglru_scan_bwd launch failed: cudaError_t {err}")
    return dxb, dr, di, dyp, dc


def _fake_bwd(xb, r_pre, i_pre, y_pre, c, h_chunks, dy):
    return (torch.empty_like(xb), torch.empty_like(xb), torch.empty_like(xb),
            torch.empty_like(xb), torch.empty_like(c))


@_build.kernel_op("rglru_scan_train", work_train, _launch_train, _fake_train)
def _rglru_train_op(xb: torch.Tensor, r_pre: torch.Tensor, i_pre: torch.Tensor,
                    y_pre: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return rglru_scan_train_torch(xb, r_pre, i_pre, y_pre, c)


@_build.kernel_op("rglru_scan_bwd", work_bwd, _launch_bwd, _fake_bwd)
def _rglru_bwd_op(xb: torch.Tensor, r_pre: torch.Tensor, i_pre: torch.Tensor,
                  y_pre: torch.Tensor, c: torch.Tensor, h_chunks: torch.Tensor,
                  dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                             torch.Tensor, torch.Tensor]:
    return rglru_scan_bwd_torch(xb, r_pre, i_pre, y_pre, c, h_chunks, dy)


def _train_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs, output[1])
    ctx.mark_non_differentiable(output[1])


def _train_backward(ctx, dy, _dh_chunks):
    with record_function(BACKWARD_SPAN):
        return rglru_scan_bwd(*ctx.saved_tensors, dy.contiguous())


_rglru_train_op.register_autograd(_train_backward, setup_context=_train_setup)


@_build.counted
def rglru_scan_train(xb: torch.Tensor, r_pre: torch.Tensor, i_pre: torch.Tensor,
                     y_pre: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper of the training forward: the custom op
    ``repro_torch::rglru_scan_train``, ``(y, h_chunks)`` — on a CUDA tensor
    one launch of ``csrc/rglru_scan.cu`` (at :func:`chunk_plan`'s chunks a
    block) that also writes the state entering each chunk of
    ``SCAN_CHUNK`` positions, on a CPU tensor :func:`rglru_scan_train_torch`.
    Its gradient is :func:`rglru_scan_bwd` on either device."""
    _build.require_cpu_or_cuda(xb, "rglru_scan kernel")
    return _rglru_train_op(xb, r_pre, i_pre, y_pre, c)


@_build.counted
def rglru_scan_bwd(xb: torch.Tensor, r_pre: torch.Tensor, i_pre: torch.Tensor,
                   y_pre: torch.Tensor, c: torch.Tensor, h_chunks: torch.Tensor,
                   dy: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Kernel wrapper of the backward: the custom op
    ``repro_torch::rglru_scan_bwd``, ``(dxb, dr_pre, di_pre, dy_pre, dc)`` —
    on a CUDA tensor the backward kernel of ``csrc/rglru_scan.cu``, on a CPU
    tensor :func:`rglru_scan_bwd_torch`."""
    _build.require_cpu_or_cuda(xb, "rglru_scan kernel")
    return _rglru_bwd_op(xb, r_pre, i_pre, y_pre, c, h_chunks, dy)


def _bind(lib: ctypes.CDLL) -> None:
    lib.rglru_scan.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.rglru_scan.restype = ctypes.c_int
    lib.rglru_scan_bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.rglru_scan_bwd.restype = ctypes.c_int
