"""Sequential composer over the manual-backward layer library; port of
``repro/nn/module.py``.

This is the runtime for the scripts that ``repro_torch.frontend.Keras2Plan``
generates — the structural analogue of the DML training script in the
paper's §2 (forward chain, backward chain in reverse, optimizer update),
with no autograd. Parameters are a list with one tuple of tensors per layer,
as in the reference; dropout draws its masks from an explicit
``torch.Generator`` where the reference takes a PRNG key.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.linearize import conv2d_out_hw
from repro_torch.nn import layers as L
from repro_torch.nn import loss as LOSS
from repro_torch.nn.optim import get_optimizer

ACTIVATIONS = ("relu", "leaky_relu", "elu", "sigmoid", "tanh", "gelu", "softmax",
               "log_softmax")


@dataclass
class LayerInstance:
    kind: str
    attrs: Dict[str, Any] = field(default_factory=dict)
    n_params: int = 0


class Sequential:
    """Build from a spec list (see repro_torch/configs/lenet.py)."""

    def __init__(self, spec: List[dict], meta: Dict[str, Any]):
        self.spec = spec
        self.meta = meta
        self.layers: List[LayerInstance] = []
        self.extras: List[Tuple] = []
        self._infer_shapes()

    # -- shape inference over the linearized pipeline ----------------------
    def _infer_shapes(self):
        shape = self.meta["input_shape"]  # (C,H,W) or (D,)
        for s in self.spec:
            kind = s["kind"]
            li = LayerInstance(kind, dict(s))
            if kind == "conv2d":
                c, h, w = shape
                k, st, pd = s["kernel"], s.get("stride", 1), s.get("pad", 0)
                ho, wo = conv2d_out_hw(h, w, k, st, pd)
                li.attrs.update(c=c, h=h, w=w)
                li.n_params = 2
                shape = (s["filters"], ho, wo)
            elif kind in ("max_pool2d", "avg_pool2d"):
                c, h, w = shape
                p = s["pool"]
                li.attrs.update(c=c, h=h, w=w)
                shape = (c, h // p, w // p)
            elif kind == "affine":
                d = int(math.prod(shape))
                li.attrs.update(d=d)
                li.n_params = 2
                shape = (s["units"],)
            elif kind == "batch_norm1d":
                li.attrs.update(d=int(math.prod(shape)))
                li.n_params = 2  # gamma, beta (+non-trainable running stats)
            elif kind == "batch_norm2d":
                c, h, w = shape
                li.attrs.update(c=c, h=h, w=w)
                li.n_params = 2
            elif kind in ACTIVATIONS or kind == "dropout":
                pass
            else:
                raise ValueError(f"unsupported layer kind {kind!r}")
            li.attrs["out_shape"] = shape
            self.layers.append(li)
        self.out_shape = shape

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator, device=None) -> List[Tuple]:
        """Weights drawn from ``generator`` in layer order (He-normal
        weights, zero biases), then moved to ``device`` (default: the
        generator's)."""
        device = generator.device if device is None else torch.device(device)
        params: List[Tuple] = []
        extras: List[Tuple] = []  # running stats etc.
        for li in self.layers:
            a = li.attrs
            if li.kind == "conv2d":
                params.append(L.conv2d.init(a["c"], a["filters"], a["kernel"], generator))
                extras.append(())
            elif li.kind == "affine":
                params.append(L.affine.init(a["d"], a["units"], generator))
                extras.append(())
            elif li.kind in ("batch_norm1d", "batch_norm2d"):
                cls = getattr(L, li.kind)
                g, bt, rm, rv = cls.init(a["d"] if li.kind == "batch_norm1d" else a["c"])
                params.append((g, bt))
                extras.append((rm.to(device), rv.to(device)))
            else:
                params.append(())
                extras.append(())
        self.extras = extras
        return [tuple(t.to(device) for t in p) for p in params]

    # -- forward (returns caches for manual backward) -----------------------
    def forward(self, params, x, *, mode: str = "train",
                generator: Optional[torch.Generator] = None):
        """In train mode dropout draws from ``generator`` (on x's device)
        and conv layers keep their patch matrices for the backward; in test
        mode dropout is the identity and no patch matrix is built."""
        train = mode == "train"
        caches = []
        for li, p in zip(self.layers, params):
            a = li.attrs
            if li.kind == "conv2d":
                out, cols = L.conv2d.forward(x, p[0], p[1], a["c"], a["h"], a["w"],
                                             a["kernel"], a.get("stride", 1), a.get("pad", 0),
                                             need_cols=train)
                caches.append(("conv2d", x, cols))
            elif li.kind == "affine":
                out = L.affine.forward(x, p[0], p[1])
                caches.append(("affine", x))
            elif li.kind in ("max_pool2d", "avg_pool2d"):
                out, _ = getattr(L, li.kind).forward(x, a["c"], a["h"], a["w"], a["pool"])
                caches.append((li.kind, x))
            elif li.kind == "dropout":
                if train:
                    out, mask = L.dropout.forward(x, a["p"], generator)
                else:
                    out, mask = x, torch.ones_like(x)
                caches.append(("dropout", mask))
            elif li.kind in ACTIVATIONS:
                out = getattr(L, li.kind).forward(x)
                caches.append((li.kind, x))
            elif li.kind == "batch_norm1d":
                out, cache, _, _ = L.batch_norm1d.forward(
                    x, p[0], p[1], mode, *self.extras[len(caches)])
                caches.append(("batch_norm1d", x, cache))
            elif li.kind == "batch_norm2d":
                out, cache, _, _ = L.batch_norm2d.forward(
                    x, p[0], p[1], a["c"], a["h"], a["w"], mode, *self.extras[len(caches)])
                caches.append(("batch_norm2d", x, cache))
            x = out
        return x, caches

    # -- backward (reverse chain, hand-written grads) ------------------------
    def backward(self, params, caches, dout):
        grads: List[Tuple] = [()] * len(self.layers)
        for i in reversed(range(len(self.layers))):
            li, p, cache = self.layers[i], params[i], caches[i]
            a = li.attrs
            if li.kind == "conv2d":
                _, x, cols = cache
                dout, dw, db = L.conv2d.backward(dout, cols, x, p[0], a["c"], a["h"],
                                                 a["w"], a["kernel"],
                                                 a.get("stride", 1), a.get("pad", 0))
                grads[i] = (dw, db)
            elif li.kind == "affine":
                _, x = cache
                dout, dw, db = L.affine.backward(dout, x, p[0], p[1])
                grads[i] = (dw, db)
            elif li.kind in ("max_pool2d", "avg_pool2d"):
                _, x = cache
                dout = getattr(L, li.kind).backward(dout, None, x, a["c"], a["h"], a["w"],
                                                    a["pool"])
            elif li.kind == "dropout":
                _, mask = cache
                dout = L.dropout.backward(dout, mask)
            elif li.kind in ACTIVATIONS:
                _, x = cache
                dout = getattr(L, li.kind).backward(dout, x)
            elif li.kind == "batch_norm1d":
                _, x, c = cache
                dout, dg, db = L.batch_norm1d.backward(dout, c, x, p[0])
                grads[i] = (dg, db)
            elif li.kind == "batch_norm2d":
                _, x, c = cache
                dout, dg, db = L.batch_norm2d.backward(dout, c, x, p[0], a["c"], a["h"], a["w"])
                grads[i] = (dg, db)
        return dout, grads

    # -- the paper's §2 training loop -----------------------------------------
    def make_train_step(self, optimizer: str = "sgd", lr: float = 0.01,
                        loss: str = "cross_entropy"):
        opt = get_optimizer(optimizer)
        if loss == "cross_entropy":
            loss_cls = LOSS.cross_entropy_loss
        elif loss == "l2":
            loss_cls = LOSS.l2_loss
        else:
            raise ValueError(loss)

        def train_step(params, opt_state, x, y, generator=None, t=1):
            """One step: (new params, new optimizer state, loss as a
            0-d tensor on the device)."""
            probs, caches = self.forward(params, x, mode="train", generator=generator)
            loss_val = loss_cls.forward(probs, y)
            dprobs = loss_cls.backward(probs, y)
            _, grads = self.backward(params, caches, dprobs)
            new_params, new_state = [], []
            for p, g, s in zip(params, grads, opt_state):
                if not p:
                    new_params.append(p)
                    new_state.append(s)
                    continue
                ps, ss = [], []
                for pj, gj, sj in zip(p, g, s):
                    pn, sn = opt.update(pj, gj, sj, lr=lr, t=t)
                    ps.append(pn)
                    ss.append(sn)
                new_params.append(tuple(ps))
                new_state.append(tuple(ss))
            return new_params, new_state, loss_val

        return train_step

    def init_opt_state(self, optimizer: str, params):
        opt = get_optimizer(optimizer)
        return [tuple(opt.init(pj) for pj in p) if p else () for p in params]

    def predict(self, params, x):
        out, _ = self.forward(params, x, mode="test")
        return out
