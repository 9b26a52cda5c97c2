"""The NN library (paper §2) — layers with ``init``/``forward``/``backward``;
port of ``repro/nn/layers.py``.

SystemML 1.0 has **no automatic differentiation**: every layer in its NN
library ships a hand-written backward pass in DML. Each layer here is a
namespace with

    init(...)                 -> params
    forward(X, ...)           -> out            (matrix in / matrix out)
    backward(dout, X, ...)    -> input/param gradients

All activations flow as **linearized 2-D matrices** (paper §3 "Tensor
Representation"): an [N, C, H, W] tensor travels as an (N, C*H*W) matrix;
conv/pool layers take (C, H, W) metadata like SystemML's
``conv2d::forward(X, W, b, C, Hin, Win, ...)``.

The two forward products go through the port's operator dispatch, as the
paper's GPU backend does: ``affine.forward`` through ``ops.matmul`` and
``conv2d.forward`` through ``ops.conv2d`` (the hand-written CUDA kernels on
the card). The backward products stay plain PyTorch, as they are plain XLA
in the reference. Autograd is never used; the tests hold every layer equal
to the reference's.

Ported so far: the layer kinds ``Sequential`` composes (affine, the eight
activations, dropout, batch_norm1d/2d, conv2d with im2col/col2im, max and
average pooling). The recurrent layers, embedding, layer/RMS norms and
scale_shift come in a later slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.linearize import conv2d_out_hw
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# affine
# ---------------------------------------------------------------------------

class affine:
    @staticmethod
    def init(d: int, m: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        # SystemML: W ~ N(0, sqrt(2/D)) (He); b = 0
        w = torch.randn((d, m), generator=generator, device=generator.device) * math.sqrt(2.0 / d)
        return w, torch.zeros((1, m), device=generator.device)

    @staticmethod
    def forward(x, w, b):
        return ops.matmul(x.contiguous(), w) + b

    @staticmethod
    def backward(dout, x, w, b):
        dx = dout @ w.T
        dw = x.T @ dout
        db = dout.sum(dim=0, keepdim=True)
        return dx, dw, db


# ---------------------------------------------------------------------------
# elementwise activations
# ---------------------------------------------------------------------------

class relu:
    @staticmethod
    def forward(x):
        return torch.clamp_min(x, 0)

    @staticmethod
    def backward(dout, x):
        return dout * (x > 0)


class leaky_relu:
    alpha = 0.01

    @classmethod
    def forward(cls, x):
        return torch.where(x > 0, x, cls.alpha * x)

    @classmethod
    def backward(cls, dout, x):
        return dout * torch.where(x > 0, 1.0, cls.alpha)


class elu:
    @staticmethod
    def forward(x, alpha: float = 1.0):
        return torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))

    @staticmethod
    def backward(dout, x, alpha: float = 1.0):
        return dout * torch.where(x > 0, 1.0, alpha * torch.exp(x))


class sigmoid:
    @staticmethod
    def forward(x):
        return 1.0 / (1.0 + torch.exp(-x))

    @staticmethod
    def backward(dout, x):
        s = sigmoid.forward(x)
        return dout * s * (1.0 - s)


class tanh:
    @staticmethod
    def forward(x):
        return torch.tanh(x)

    @staticmethod
    def backward(dout, x):
        t = torch.tanh(x)
        return dout * (1.0 - t * t)


class gelu:
    """tanh-approximate GELU (matches the transformer stack)."""

    _c = math.sqrt(2.0 / math.pi)

    @classmethod
    def forward(cls, x):
        inner = cls._c * (x + 0.044715 * x**3)
        return 0.5 * x * (1.0 + torch.tanh(inner))

    @classmethod
    def backward(cls, dout, x):
        inner = cls._c * (x + 0.044715 * x**3)
        t = torch.tanh(inner)
        dinner = cls._c * (1.0 + 3 * 0.044715 * x**2)
        return dout * (0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * dinner)


class softmax:
    @staticmethod
    def forward(x):
        z = x - x.amax(dim=1, keepdim=True)
        e = torch.exp(z)
        return e / e.sum(dim=1, keepdim=True)

    @staticmethod
    def backward(dout, x):
        p = softmax.forward(x)
        return p * (dout - (dout * p).sum(dim=1, keepdim=True))


class log_softmax:
    @staticmethod
    def forward(x):
        z = x - x.amax(dim=1, keepdim=True)
        return z - torch.log(torch.exp(z).sum(dim=1, keepdim=True))

    @staticmethod
    def backward(dout, x):
        p = softmax.forward(x)
        return dout - p * dout.sum(dim=1, keepdim=True)


# ---------------------------------------------------------------------------
# dropout (inverted dropout, as in SystemML's nn/layers/dropout.dml)
# ---------------------------------------------------------------------------

class dropout:
    @staticmethod
    def forward(x, p: float, generator: torch.Generator):
        """The keep mask comes from ``generator``, which must live on x's
        device."""
        u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        mask = (u > p) / (1.0 - p)
        return x * mask, mask

    @staticmethod
    def backward(dout, mask):
        return dout * mask


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

class batch_norm1d:
    eps = 1e-5

    @staticmethod
    def init(d: int, device=None):
        # gamma, beta, running_mean, running_var
        return (torch.ones((1, d), device=device), torch.zeros((1, d), device=device),
                torch.zeros((1, d), device=device), torch.ones((1, d), device=device))

    @staticmethod
    def forward(x, gamma, beta, mode: str = "train",
                running_mean=None, running_var=None, momentum: float = 0.9):
        if mode == "train":
            mu = x.mean(dim=0, keepdim=True)
            var = x.var(dim=0, keepdim=True, unbiased=False)
            new_rm = (momentum * running_mean + (1 - momentum) * mu
                      if running_mean is not None else mu)
            new_rv = (momentum * running_var + (1 - momentum) * var
                      if running_var is not None else var)
        else:
            mu, var = running_mean, running_var
            new_rm, new_rv = running_mean, running_var
        xhat = (x - mu) / torch.sqrt(var + batch_norm1d.eps)
        return gamma * xhat + beta, (xhat, mu, var), new_rm, new_rv

    @staticmethod
    def backward(dout, cache, x, gamma):
        xhat, mu, var = cache
        n = x.shape[0]
        istd = 1.0 / torch.sqrt(var + batch_norm1d.eps)
        dgamma = (dout * xhat).sum(dim=0, keepdim=True)
        dbeta = dout.sum(dim=0, keepdim=True)
        dxhat = dout * gamma
        dx = istd / n * (n * dxhat - dxhat.sum(dim=0, keepdim=True)
                         - xhat * (dxhat * xhat).sum(dim=0, keepdim=True))
        return dx, dgamma, dbeta


class batch_norm2d:
    """Spatial batch-norm on linearized (N, C*H*W) input."""

    @staticmethod
    def init(c: int, device=None):
        return batch_norm1d.init(c, device)

    @staticmethod
    def forward(x, gamma, beta, c, h, w, mode="train",
                running_mean=None, running_var=None, momentum=0.9):
        n = x.shape[0]
        # (N, C*H*W) -> (N*H*W, C): per-channel statistics
        xc = x.reshape(n, c, h * w).transpose(1, 2).reshape(n * h * w, c)
        out, cache, rm, rv = batch_norm1d.forward(
            xc, gamma, beta, mode, running_mean, running_var, momentum)
        out = out.reshape(n, h * w, c).transpose(1, 2).reshape(n, c * h * w)
        return out, (cache, xc), rm, rv

    @staticmethod
    def backward(dout, cache, x, gamma, c, h, w):
        inner_cache, xc = cache
        n = x.shape[0]
        doutc = dout.reshape(n, c, h * w).transpose(1, 2).reshape(n * h * w, c)
        dxc, dgamma, dbeta = batch_norm1d.backward(doutc, inner_cache, xc, gamma)
        dx = dxc.reshape(n, h * w, c).transpose(1, 2).reshape(n, c * h * w)
        return dx, dgamma, dbeta


# ---------------------------------------------------------------------------
# conv2d — im2col lowering (paper ref [5]) on linearized matrices
# ---------------------------------------------------------------------------

def im2col(x2d, c, h, w, kernel, stride, pad):
    """(N, C*H*W) -> (N, Ho*Wo, C*k*k) patch matrix, columns channel-major,
    then kernel row, then kernel column (the reference's order). Built from
    strided windows of the padded image in one copy."""
    n = x2d.shape[0]
    ho, wo = conv2d_out_hw(h, w, kernel, stride, pad)
    x = F.pad(x2d.reshape(n, c, h, w), (pad, pad, pad, pad))
    win = x.unfold(2, kernel, stride).unfold(3, kernel, stride)   # (N, C, Ho, Wo, k, k)
    return win.permute(0, 2, 3, 1, 4, 5).reshape(n, ho * wo, c * kernel * kernel)


def col2im(dcols, c, h, w, kernel, stride, pad):
    """Scatter-add patch gradients back to the (N, C*H*W) image — the
    transpose of im2col (taps in the padding are dropped)."""
    n = dcols.shape[0]
    out = F.fold(dcols.transpose(1, 2), (h, w), kernel, padding=pad, stride=stride)
    return out.reshape(n, c * h * w)


class conv2d:
    @staticmethod
    def init(c: int, filters: int, kernel: int, generator: torch.Generator):
        fan_in = c * kernel * kernel
        w = (torch.randn((filters, fan_in), generator=generator, device=generator.device)
             * math.sqrt(2.0 / fan_in))
        return w, torch.zeros((filters, 1), device=generator.device)

    @staticmethod
    def forward(x2d, w, b, c, h, w_in, kernel, stride, pad, need_cols: bool = True):
        """(N, C*H*W) -> ((N, F*Ho*Wo), cols). The output comes from
        ``ops.conv2d`` on the NCHW view of x with w (F, C*k*k) viewed as
        (F, C, k, k), plus the bias. ``cols``, the (N, Ho*Wo, C*k*k) patch
        matrix the backward reads, is built only when ``need_cols`` (a
        training step); it is None otherwise."""
        n = x2d.shape[0]
        f = w.shape[0]
        x = x2d.contiguous().reshape(n, c, h, w_in)
        out = ops.conv2d(x, w.contiguous().reshape(f, c, kernel, kernel), stride, pad)
        out = (out + b.reshape(1, f, 1, 1)).reshape(n, -1)   # (N, F*Ho*Wo)
        cols: Optional[torch.Tensor] = (im2col(x2d, c, h, w_in, kernel, stride, pad)
                                        if need_cols else None)
        return out, cols

    @staticmethod
    def backward(dout, cols, x2d, w, c, h, w_in, kernel, stride, pad):
        n = x2d.shape[0]
        f = w.shape[0]
        ho, wo = conv2d_out_hw(h, w_in, kernel, stride, pad)
        do_ = dout.reshape(n, f, ho * wo).transpose(1, 2)       # (N, HoWo, F)
        dw = torch.einsum("npf,npk->fk", do_, cols)
        db = do_.sum(dim=(0, 1))[:, None]
        dcols = torch.einsum("npf,fk->npk", do_, w)             # (N, HoWo, Ckk)
        dx = col2im(dcols, c, h, w_in, kernel, stride, pad)
        return dx, dw, db


# ---------------------------------------------------------------------------
# pooling (stride == pool, dims divisible — the SystemML demo-model cases)
# ---------------------------------------------------------------------------

class max_pool2d:
    @staticmethod
    def forward(x2d, c, h, w, pool):
        # the reference's window max (a max is exact, so any order agrees);
        # F.max_pool2d reads the image once where a reduction over the
        # (N, C, H/p, p, W/p, p) view strides through it
        n = x2d.shape[0]
        out = F.max_pool2d(x2d.reshape(n, c, h, w), pool)
        return out.reshape(n, -1), None

    @staticmethod
    def backward(dout, _cache, x2d, c, h, w, pool):
        n = x2d.shape[0]
        x = x2d.reshape(n, c, h // pool, pool, w // pool, pool)
        mx = x.amax(dim=(3, 5), keepdim=True)
        mask = (x == mx).to(x.dtype)
        # split ties evenly (the subgradient the reference takes)
        mask = mask / mask.sum(dim=(3, 5), keepdim=True)
        d = dout.reshape(n, c, h // pool, 1, w // pool, 1)
        return (mask * d).reshape(n, -1)


class avg_pool2d:
    @staticmethod
    def forward(x2d, c, h, w, pool):
        n = x2d.shape[0]
        x = x2d.reshape(n, c, h // pool, pool, w // pool, pool)
        return x.mean(dim=(3, 5)).reshape(n, -1), None

    @staticmethod
    def backward(dout, _cache, x2d, c, h, w, pool):
        n = x2d.shape[0]
        d = dout.reshape(n, c, h // pool, 1, w // pool, 1)
        d = (d / (pool * pool)).expand(n, c, h // pool, pool, w // pool, pool)
        return d.reshape(n, -1)
