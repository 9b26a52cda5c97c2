"""conv2d via im2col: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/conv2d_im2col.py`` (``conv2d_im2col``, body
``_conv_kernel``): an NCHW x OIHW convolution with a square kernel, stride
and symmetric zero padding (no bias, no dilation), computed as the patch
matrix ``(Ho*Wo, C*k*k)`` of each image times the ``(C*k*k, F)`` filters,
accumulated in float32, output ``(N, F, Ho, Wo)`` in x's dtype. The patch
columns are ordered channel-major, then kernel row, then kernel column.

- :func:`conv2d_im2col` is the kernel wrapper, the custom op
  ``repro_torch::conv2d_im2col`` (:func:`work` counts a call's FLOPs and
  bytes): on a CUDA tensor it launches
  ``csrc/conv2d_im2col.cu``, an implicit GEMM whose patch matrix never
  reaches device memory (float32 on the tensor cores in 3xTF32, bfloat16
  inputs on the CUDA cores), raising on anything the kernel does not take;
  on a CPU tensor it runs the plain version.
- :func:`conv2d_torch` is the plain version: the reference's lowering, an
  explicit im2col (``unfold``) followed by a product.
- :func:`conv2d_tf32x3_torch` models the float32 kernel's rounding (tests
  only): each operand split into a TF32 hi part and a lo part read as TF32,
  three products.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.linearize import conv2d_out_hw
from repro_torch.kernels import _build
from repro_torch.kernels.ref import tf32_round, tf32_truncate

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_INDEX = 2**31 - 1
# blockIdx.y covers the filters in tiles of up to 128
_MAX_FILTERS = 65535 * 32


def conv2d_torch(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 pad: int = 0) -> torch.Tensor:
    """Plain version: x (N, C, H, W), w (F, C, k, k) -> (N, F, Ho, Wo);
    the (N, C*k*k, Ho*Wo) patches times the (F, C*k*k) filters in float32,
    rounded to x's dtype."""
    n, _, h, wd = x.shape
    f, _, k, _ = w.shape
    ho, wo = conv2d_out_hw(h, wd, k, stride, pad)
    cols = F.unfold(x.float(), k, padding=pad, stride=stride)      # (N, C*k*k, Ho*Wo)
    out = w.reshape(f, -1).float() @ cols                            # (N, F, Ho*Wo)
    return out.reshape(n, f, ho, wo).to(x.dtype)


def conv2d_tf32x3_torch(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                        pad: int = 0, terms: int = 3) -> torch.Tensor:
    """The float32 kernel's arithmetic: x (N, C, H, W), w (F, C, k, k) ->
    float32 (N, F, Ho, Wo). Patches and filters are split as hi = tf32(v)
    (rounded), lo = v - hi (read as TF32, truncated); the output is hi.hi +
    (lo.hi + hi.lo), each product of TF32 values exact in float32 and summed
    in float32. ``terms=1`` keeps hi.hi alone: a plain TF32 product."""
    n, _, h, wd = x.shape
    f, _, k, _ = w.shape
    ho, wo = conv2d_out_hw(h, wd, k, stride, pad)
    cols = F.unfold(x.float(), k, padding=pad, stride=stride)      # (N, C*k*k, Ho*Wo)
    wm = w.reshape(f, -1).float()
    c_hi, w_hi = tf32_round(cols), tf32_round(wm)
    out = w_hi @ c_hi
    if terms == 3:
        c_lo, w_lo = tf32_truncate(cols - c_hi), tf32_truncate(wm - w_hi)
        out = out + (w_hi @ c_lo + w_lo @ c_hi)
    return out.reshape(n, f, ho, wo)


def _check(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int) -> None:
    """Raise with the reason on anything the CUDA kernel does not take."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv2d takes x (N, C, H, W) and w (F, C, k, k), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, c, h, wd = x.shape
    f, cw, k, k2 = w.shape
    if cw != c or k2 != k:
        raise ValueError(f"w must be (F, {c}, k, k) with a square kernel, got {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv2d kernel takes float32 or bfloat16 x and w of one dtype, "
                        f"got {x.dtype} and {w.dtype}")
    if stride < 1 or pad < 0 or k < 1:
        raise ValueError(f"conv2d kernel needs stride >= 1, pad >= 0, k >= 1, got "
                         f"stride={stride}, pad={pad}, k={k}")
    if h + 2 * pad < k or wd + 2 * pad < k or min(n, c, f) < 1:
        raise ValueError(f"conv2d kernel: empty input or output for x {tuple(x.shape)}, "
                         f"k={k}, pad={pad}")
    ho, wo = conv2d_out_hw(h, wd, k, stride, pad)
    if max(x.numel(), n * f * ho * wo) > _MAX_INDEX or f > _MAX_FILTERS:
        raise ValueError(f"conv2d kernel indexes positions with 32-bit ints: x "
                         f"{tuple(x.shape)} with {f} filters is too large")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("conv2d kernel takes contiguous x and w")


def work(x, w, stride: int = 1, pad: int = 0) -> _build.Work:
    """FLOPs and bytes of one call: 2 x output elements x C k k; x and w
    read, the output written."""
    n, c, h, wd = x.shape
    f, _, k, _ = w.shape
    ho, wo = conv2d_out_hw(h, wd, k, stride, pad)
    return _build.Work(2 * n * ho * wo * f * c * k * k,
                       (x.numel() + w.numel() + n * f * ho * wo) * x.element_size())


def _launch(x, w, stride, pad):
    """CUDA implementation of ``repro_torch::conv2d_im2col``, counted in
    ``conv2d_im2col.launches``."""
    _check(x, w, stride, pad)
    n, c, h, wd = x.shape
    f, _, k, _ = w.shape
    ho, wo = conv2d_out_hw(h, wd, k, stride, pad)
    lib = _build.library("conv2d_im2col", _bind)
    out = torch.empty((n, f, ho, wo), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_conv2d_im2col(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                      _DTYPES[x.dtype], n, c, h, wd, f, k, stride, pad,
                                      stream)
    conv2d_im2col.launches += 1
    if err:
        raise RuntimeError(f"conv2d_im2col launch failed: cudaError_t {err}")
    return out


def _fake(x, w, stride, pad):
    ho, wo = conv2d_out_hw(x.shape[2], x.shape[3], w.shape[2], stride, pad)
    return x.new_empty((x.shape[0], w.shape[0], ho, wo))


@_build.kernel_op("conv2d_im2col", work, _launch, _fake)
def _conv_op(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    return conv2d_torch(x, w, stride=stride, pad=pad)


@_build.counted
def conv2d_im2col(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                  pad: int = 0) -> torch.Tensor:
    """Kernel wrapper: the custom op ``repro_torch::conv2d_im2col``, which
    launches ``csrc/conv2d_im2col.cu`` on a CUDA tensor and runs
    :func:`conv2d_torch` on a CPU tensor."""
    _build.require_cpu_or_cuda(x, "conv2d kernel")
    return _conv_op(x, w, stride, pad)


def _bind(lib: ctypes.CDLL) -> None:
    lib.repro_conv2d_im2col.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                                        + [ctypes.c_void_p])
    lib.repro_conv2d_im2col.restype = ctypes.c_int
