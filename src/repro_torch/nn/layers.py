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

Every layer of the reference is ported: the kinds ``Sequential`` composes
(affine, the eight activations, dropout, batch_norm1d/2d, conv2d with
im2col/col2im, max and average pooling), layer_norm, rms_norm, scale_shift,
embedding (its backward a scatter-add, ``index_add_``, which sums repeated
ids as the reference's ``.at[ids].add`` does), and the recurrent simple_rnn
and lstm, whose ``lax.scan`` over time becomes a loop over T (backward: the
same loop in reverse, manual BPTT). Each ``init`` takes a
``torch.Generator`` and builds its tensors on the generator's device.
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


class layer_norm:
    eps = 1e-5

    @staticmethod
    def init(d: int, generator: Optional[torch.Generator] = None):
        dev = generator.device if generator is not None else None
        return torch.ones((1, d), device=dev), torch.zeros((1, d), device=dev)

    @staticmethod
    def forward(x, gamma, beta):
        mu = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, keepdim=True, unbiased=False)
        xhat = (x - mu) / torch.sqrt(var + layer_norm.eps)
        return gamma * xhat + beta, (xhat, var)

    @staticmethod
    def backward(dout, cache, x, gamma):
        xhat, var = cache
        d = x.shape[1]
        istd = 1.0 / torch.sqrt(var + layer_norm.eps)
        dgamma = (dout * xhat).sum(dim=0, keepdim=True)
        dbeta = dout.sum(dim=0, keepdim=True)
        dxhat = dout * gamma
        dx = istd / d * (d * dxhat - dxhat.sum(dim=1, keepdim=True)
                         - xhat * (dxhat * xhat).sum(dim=1, keepdim=True))
        return dx, dgamma, dbeta


class rms_norm:
    eps = 1e-5

    @staticmethod
    def init(d: int, generator: Optional[torch.Generator] = None):
        dev = generator.device if generator is not None else None
        return (torch.ones((1, d), device=dev),)

    @staticmethod
    def forward(x, gamma):
        ms = (x * x).mean(dim=1, keepdim=True)
        inv = 1.0 / torch.sqrt(ms + rms_norm.eps)
        return gamma * x * inv, inv

    @staticmethod
    def backward(dout, inv, x, gamma):
        d = x.shape[1]
        dgamma = (dout * x * inv).sum(dim=0, keepdim=True)
        dxhat = dout * gamma
        dx = inv * dxhat - (inv ** 3 / d) * x * (dxhat * x).sum(dim=1, keepdim=True)
        return dx, dgamma


class scale_shift:
    """SystemML nn/layers/scale_shift*.dml: out = gamma*x + beta."""

    @staticmethod
    def init(d: int, generator: Optional[torch.Generator] = None):
        dev = generator.device if generator is not None else None
        return torch.ones((1, d), device=dev), torch.zeros((1, d), device=dev)

    @staticmethod
    def forward(x, gamma, beta):
        return gamma * x + beta

    @staticmethod
    def backward(dout, x, gamma):
        return dout * gamma, (dout * x).sum(0, keepdim=True), dout.sum(0, keepdim=True)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------

class embedding:
    @staticmethod
    def init(vocab: int, d: int, generator: torch.Generator):
        return (torch.randn((vocab, d), generator=generator, device=generator.device) * 0.02,)

    @staticmethod
    def forward(ids, table):
        return table[ids.long()]

    @staticmethod
    def backward(dout, ids, table):
        d = table.shape[1]
        return torch.zeros_like(table).index_add_(0, ids.reshape(-1).long(),
                                                  dout.reshape(-1, d).to(table.dtype))


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


# ---------------------------------------------------------------------------
# recurrent layers (simple RNN + LSTM), manual BPTT
# ---------------------------------------------------------------------------

class simple_rnn:
    @staticmethod
    def init(d: int, m: int, generator: torch.Generator):
        dev = generator.device
        wx = torch.randn((d, m), generator=generator, device=dev) * math.sqrt(1.0 / d)
        wh = torch.randn((m, m), generator=generator, device=dev) * math.sqrt(1.0 / m)
        return wx, wh, torch.zeros((1, m), device=dev)

    @staticmethod
    def forward(x, wx, wh, b, h0):
        """x: (N, T, D); returns (hs: (N, T, M), the last h)."""
        h, hs = h0, []
        for t in range(x.shape[1]):
            h = torch.tanh(x[:, t] @ wx + h @ wh + b)
            hs.append(h)
        return torch.stack(hs, dim=1), h

    @staticmethod
    def backward(dhs, x, wx, wh, b, h0):
        """Manual BPTT: the loop over time in reverse."""
        hs, _ = simple_rnn.forward(x, wx, wh, b, h0)
        n, t, m = dhs.shape
        h0b = h0.expand(n, m)[:, None, :]
        hs_prev = torch.cat([h0b, hs[:, :-1]], dim=1)
        dh_next = torch.zeros((n, m), dtype=dhs.dtype, device=dhs.device)
        dxs, dwxs, dwhs, dbs = [], [], [], []
        for i in reversed(range(t)):
            ht, hprev, xt = hs[:, i], hs_prev[:, i], x[:, i]
            dh = dhs[:, i] + dh_next
            da = dh * (1.0 - ht * ht)
            dxs.append(da @ wx.T)
            dwxs.append(xt.T @ da)
            dwhs.append(hprev.T @ da)
            dbs.append(da.sum(0, keepdim=True))
            dh_next = da @ wh.T
        return (torch.stack(dxs[::-1], dim=1), torch.stack(dwxs).sum(0),
                torch.stack(dwhs).sum(0), torch.stack(dbs).sum(0), dh_next)


class lstm:
    @staticmethod
    def init(d: int, m: int, generator: torch.Generator):
        dev = generator.device
        wx = torch.randn((d, 4 * m), generator=generator, device=dev) * math.sqrt(1.0 / d)
        wh = torch.randn((m, 4 * m), generator=generator, device=dev) * math.sqrt(1.0 / m)
        return wx, wh, torch.zeros((1, 4 * m), device=dev)

    @staticmethod
    def _gates(a, m):
        i = sigmoid.forward(a[:, :m])
        f = sigmoid.forward(a[:, m:2 * m])
        o = sigmoid.forward(a[:, 2 * m:3 * m])
        g = torch.tanh(a[:, 3 * m:])
        return i, f, o, g

    @staticmethod
    def forward(x, wx, wh, b, h0, c0):
        """x: (N, T, D); returns (hs: (N, T, M), (hT, cT), cache), the cache
        time-major: (hs, cs, i, f, o, g), each (T, N, M)."""
        m = h0.shape[1]
        h, c = h0, c0
        steps = []
        for t in range(x.shape[1]):
            a = x[:, t] @ wx + h @ wh + b
            i, f, o, g = lstm._gates(a, m)
            c = f * c + i * g
            h = o * torch.tanh(c)
            steps.append((h, c, i, f, o, g))
        cache = tuple(torch.stack(parts) for parts in zip(*steps))
        return cache[0].transpose(0, 1), (h, c), cache

    @staticmethod
    def backward(dhs, cache, x, wx, wh, b, h0, c0):
        """Manual BPTT: the loop over time in reverse. Returns (dx, dwx,
        dwh, db, dh0, dc0)."""
        hs, cs, i_, f_, o_, g_ = cache
        n, t, _ = dhs.shape
        m = h0.shape[1]
        hs_prev = torch.cat([h0[None], hs[:-1]], dim=0)   # (T, N, M)
        cs_prev = torch.cat([c0[None], cs[:-1]], dim=0)
        dh_next = torch.zeros((n, m), dtype=dhs.dtype, device=dhs.device)
        dc_next = torch.zeros_like(dh_next)
        dxs, dwxs, dwhs, dbs = [], [], [], []
        for k in reversed(range(t)):
            ct, it, ft, ot, gt = cs[k], i_[k], f_[k], o_[k], g_[k]
            dh = dhs[:, k] + dh_next
            tc = torch.tanh(ct)
            do = dh * tc
            dc = dc_next + dh * ot * (1 - tc * tc)
            di = dc * gt
            df = dc * cs_prev[k]
            dg = dc * it
            da = torch.cat([di * it * (1 - it), df * ft * (1 - ft),
                            do * ot * (1 - ot), dg * (1 - gt * gt)], dim=1)
            dxs.append(da @ wx.T)
            dwxs.append(x[:, k].T @ da)
            dwhs.append(hs_prev[k].T @ da)
            dbs.append(da.sum(0, keepdim=True))
            dh_next, dc_next = da @ wh.T, dc * ft
        return (torch.stack(dxs[::-1], dim=1), torch.stack(dwxs).sum(0),
                torch.stack(dwhs).sum(0), torch.stack(dbs).sum(0), dh_next, dc_next)
