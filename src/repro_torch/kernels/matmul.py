"""Tiled matrix product: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/matmul.py`` (``matmul``, body ``_matmul_kernel``):
``(M, K) @ (K, N)`` with a float32 accumulator and the output in ``a``'s
dtype, at any M, N, K — the paper's "Native BLAS" / "GPU backend" point
that compute-bound operators go to a tuned kernel.

- :func:`matmul` is the kernel wrapper, the custom op ``repro_torch::matmul``
  (:func:`work` counts a call's FLOPs and bytes): on a CUDA tensor it launches
  ``csrc/matmul.cu`` (float32 on the tensor cores in 3xTF32 through
  ``wgmma``, bfloat16 through ``mma.sync``; ragged edges masked in the
  kernel; a float32 product with few output tiles and a deep K split along
  K, see :func:`splits_for`), raising on anything the kernel does not take;
  on a CPU tensor it runs the plain version.
- :func:`matmul_torch` is the plain version.
- :func:`matmul_tf32x3_torch` models the float32 kernel's rounding (tests
  only): each operand split into a TF32 hi part and a lo part read as TF32,
  three products.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.hw import sm_count
from repro_torch.kernels import _build
from repro_torch.kernels.ref import tf32_round, tf32_truncate

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel indexes with 32-bit dims; blockIdx.y covers N in 128-column tiles
_MAX_DIM = 2**31 - 1
_MAX_N = 65535 * 128
# the float32 path's block tile rows, and the least depth worth a split of
# its own
_TILE_M = 128
_MIN_SPLIT_DEPTH = 256


def tile_n(n: int) -> int:
    """Columns of the float32 kernel's block tile: the smallest of 32, 64
    and 128 that covers N up to 128 (``csrc/matmul.cu`` chooses the same)."""
    return 32 if n <= 32 else 64 if n <= 64 else 128


def splits_for(m: int, n: int, k: int, sm_count: int) -> int:
    """How many parts a float32 product's depth is cut into: 1 while its
    128-row output tiles give every SM a block, else enough parts to fill
    the SMs, each at least 256 deep (LeNet's first affine layer at batch 64,
    (64, 3136) @ (3136, 512): 4 tiles of 128 x 128, 12 parts)."""
    tiles = math.ceil(m / _TILE_M) * math.ceil(n / tile_n(n))
    if tiles >= sm_count:
        return 1
    return max(1, min(math.ceil(sm_count / tiles), k // _MIN_SPLIT_DEPTH))


def kernel_name(dtype: torch.dtype) -> str:
    """The ``csrc/matmul.cu`` kernel a product of this dtype runs."""
    return "repro_mm_tf32x3" if dtype == torch.float32 else "repro_mm_bf16"


def matmul_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: the product in float32, rounded to a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def matmul_tf32x3_torch(a: torch.Tensor, b: torch.Tensor, *, terms: int = 3) -> torch.Tensor:
    """The float32 kernel's arithmetic: a (M, K) @ b (K, N) -> float32. Both
    operands are split as hi = tf32(v) (rounded), lo = v - hi (read as TF32,
    truncated); the output is hi.hi + (hi.lo + lo.hi), each product of TF32
    values exact in float32 and summed in float32. ``terms=1`` keeps hi.hi
    alone: a plain TF32 product."""
    af, bf = a.float(), b.float()
    a_hi, b_hi = tf32_round(af), tf32_round(bf)
    out = a_hi @ b_hi
    if terms == 3:
        a_lo, b_lo = tf32_truncate(af - a_hi), tf32_truncate(bf - b_hi)
        out = out + (a_hi @ b_lo + a_lo @ b_hi)
    return out


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    """Raise with the reason on anything the CUDA kernel does not take."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul takes (M, K) @ (K, N), got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"matmul kernel takes float32 or bfloat16 operands of one dtype, "
                        f"got {a.dtype} and {b.dtype}")
    (m, k), n = a.shape, b.shape[1]
    if min(m, n, k) < 1:
        raise ValueError(f"matmul kernel needs M, N, K >= 1, got ({m}, {k}) @ ({k}, {n})")
    if max(m, k) > _MAX_DIM or n > _MAX_N:
        raise ValueError(f"matmul kernel takes M, K < 2**31 and N <= {_MAX_N}, "
                         f"got M={m}, K={k}, N={n}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if not a.is_contiguous() or not b.is_contiguous():
        raise ValueError("matmul kernel takes contiguous (row-major) operands")


def work(a, b) -> _build.Work:
    """FLOPs and bytes of one call: 2 M N K; a and b read, the output
    written."""
    (m, k), n = a.shape, b.shape[1]
    return _build.Work(2 * m * n * k, (m * k + k * n + m * n) * a.element_size())


def _launch(a, b):
    """CUDA implementation of ``repro_torch::matmul``, counted in
    ``matmul.launches``."""
    _check(a, b)
    (m, k), n = a.shape, b.shape[1]
    lib = _build.library("matmul", _bind)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    splits = splits_for(m, n, k, sm_count(a.device)) if a.dtype == torch.float32 else 1
    # the float32 partial products of a split-K launch
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
            if splits > 1 else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               part.data_ptr() if part is not None else None,
                               _DTYPES[a.dtype], m, n, k, splits, stream)
    matmul.launches += 1
    if err:
        raise RuntimeError(f"matmul launch failed: cudaError_t {err}")
    return out


def _fake(a, b):
    return a.new_empty((a.shape[0], b.shape[1]))


@_build.kernel_op("matmul", work, _launch, _fake)
def _matmul_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return matmul_torch(a, b)


@_build.counted
def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: the custom op ``repro_torch::matmul``, which launches
    ``csrc/matmul.cu`` on a CUDA tensor and runs :func:`matmul_torch` on a
    CPU tensor."""
    _build.require_cpu_or_cuda(a, "matmul kernel")
    return _matmul_op(a, b)


def _bind(lib: ctypes.CDLL) -> None:
    lib.repro_matmul.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.repro_matmul.restype = ctypes.c_int
