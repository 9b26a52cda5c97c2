"""Keras2Plan — the Keras2DML/Caffe2DML analogue (paper §2); port of
``repro/frontend/keras2plan.py``.

Accepts a declarative layer spec (the Keras ``Sequential`` role), generates
the equivalent *DML-like script text* (byte-identical to the reference's),
and trains and scores through the port's NN library on a torch device:

* ``train_algo="minibatch"``  — a for-loop over batches (the paper's
  generated minibatch script);
* ``train_algo="batch"``      — full-batch steps;
* ``test_algo="serial"`` — one scoring pass over all rows;
  ``test_algo="allreduce"`` with a ``mesh`` (a ``DeviceMesh`` over the
  process group's ranks) — remote parfor (``core/parfor.py``): each rank
  scores its own block of rows, with no collective in the body, and the
  blocks are gathered once at the end. ``fit`` runs on one device, as the
  reference's does.

The sklearn-style ``fit(X, Y)`` / ``predict(X)`` entry points accept NumPy
arrays. The estimator runs on the card (``device="cuda"``) unless the
caller names another device; with no card it raises, it never falls back
to the CPU silently. The input matrix moves to the device once; the loss
history is read back once, at the end of ``fit``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.parfor import parfor
from repro_torch.core.sharding import gather_blocks
from repro_torch.core.sparsity import characteristics, select_format
from repro_torch.nn.module import Sequential


def generate_dml(spec: List[dict], meta: Dict, optimizer: str, lr: float,
                 batch_size: int) -> str:
    """Generate the DML script a Keras2DML user would get (paper §2)."""
    lines = []
    kinds = sorted({s["kind"] for s in spec})
    for k in kinds:
        lines.append(f'source("nn/layers/{k}.dml") as {k}')
    lines.append(f'source("nn/optim/{optimizer}.dml") as {optimizer}')
    lines.append("")
    lines.append("train = function(matrix[double] X, matrix[double] Y) {")
    lines.append(f"  lr = {lr}; batch_size = {batch_size}")
    lines.append("  num_iter = nrow(X) / batch_size")
    for i, s in enumerate(spec):
        if s["kind"] == "affine":
            lines.append(f"  [W{i}, b{i}] = affine::init(D{i}, {s['units']})")
        elif s["kind"] == "conv2d":
            lines.append(
                f"  [W{i}, b{i}] = conv2d::init({s['filters']}, C{i}, "
                f"{s['kernel']}, {s['kernel']})")
    lines.append("  for (i in 1:num_iter) {")
    lines.append("    beg = (i-1)*batch_size + 1; end = beg + batch_size")
    lines.append("    X_batch = X[beg:end,]; y_batch = Y[beg:end,]")
    lines.append("    # forward")
    prev = "X_batch"
    for i, s in enumerate(spec):
        k = s["kind"]
        arg = f"{prev}, W{i}, b{i}" if k in ("affine", "conv2d") else prev
        lines.append(f"    out{i} = {k}::forward({arg})")
        prev = f"out{i}"
    lines.append("    # backward")
    lines.append(f"    dprobs = cross_entropy_loss::backward({prev}, y_batch)")
    grad = "dprobs"
    for i in reversed(range(len(spec))):
        k = spec[i]["kind"]
        if k in ("affine", "conv2d"):
            lines.append(
                f"    [d{i}, dW{i}, db{i}] = {k}::backward({grad}, ...)")
            lines.append(f"    W{i} = {optimizer}::update(W{i}, dW{i}, lr)")
            lines.append(f"    b{i} = {optimizer}::update(b{i}, db{i}, lr)")
        else:
            lines.append(f"    d{i} = {k}::backward({grad}, ...)")
        grad = f"d{i}"
    lines.append("  }")
    lines.append("}")
    return "\n".join(lines)


def step_seed(seed: int, t: int) -> int:
    """Seed of step ``t``'s dropout generator: a function of (seed, t), as
    the reference keys step t's dropout with ``PRNGKey(t)``."""
    return int(np.random.SeedSequence((seed, t)).generate_state(1)[0])


class Keras2Plan:
    """sklearn/MLPipeline-style estimator over the repro_torch.nn runtime."""

    def __init__(self, spec: List[dict], meta: Dict, *,
                 optimizer: str = "sgd", lr: float = 0.01,
                 batch_size: int = 32, epochs: int = 1,
                 train_algo: str = "minibatch", test_algo: str = "allreduce",
                 mesh=None, seed: int = 0, device="cuda"):
        if train_algo not in ("minibatch", "batch"):
            raise ValueError(train_algo)
        if test_algo not in ("allreduce", "serial"):
            raise ValueError(test_algo)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        self.spec, self.meta = spec, meta
        self.optimizer, self.lr = optimizer, lr
        self.batch_size, self.epochs = batch_size, epochs
        self.train_algo, self.test_algo = train_algo, test_algo
        self.mesh = mesh
        self.seed = seed
        self.module = Sequential(spec, meta)
        self.params = None
        self.opt_state = None
        self.dml_script = generate_dml(spec, meta, optimizer, lr, batch_size)
        self.history: List[float] = []
        self.format_decisions: Dict[str, str] = {}

    # ------------------------------------------------------------------
    def set(self, **kw) -> "Keras2Plan":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise AttributeError(k)
            setattr(self, k, v)
        return self

    # ------------------------------------------------------------------
    def fit(self, X: np.ndarray, Y: np.ndarray) -> "Keras2Plan":
        X = np.asarray(X, np.float32)
        Y = np.asarray(Y, np.float32)
        # SystemML's format decision on the input matrix
        self.format_decisions["X"] = select_format(characteristics(X))
        # weights from a CPU generator: the same seed gives the same weights
        # on every device
        self.params = self.module.init(torch.Generator().manual_seed(self.seed),
                                       device=self.device)
        self.opt_state = self.module.init_opt_state(self.optimizer, self.params)
        step = self.module.make_train_step(self.optimizer, self.lr)
        xs = torch.from_numpy(X).to(self.device)
        ys = torch.from_numpy(Y).to(self.device)
        drop = torch.Generator(device=self.device)
        n = X.shape[0]
        bs = n if self.train_algo == "batch" else self.batch_size
        t = 0
        losses = []
        for _ in range(self.epochs):
            for beg in range(0, n - bs + 1, bs):
                t += 1
                drop.manual_seed(step_seed(self.seed, t))
                self.params, self.opt_state, loss = step(
                    self.params, self.opt_state, xs[beg:beg + bs], ys[beg:beg + bs],
                    drop, t=t)
                losses.append(loss)
        if losses:
            self.history.extend(torch.stack(losses).tolist())
        return self

    # ------------------------------------------------------------------
    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        if self.params is None:
            raise RuntimeError("fit first")
        xs = torch.from_numpy(np.asarray(X, np.float32)).to(self.device)
        if self.test_algo == "allreduce" and self.mesh is not None:
            out, plan = parfor(lambda rows: self.module.predict(self.params, rows),
                               xs, mesh=self.mesh)
            self._last_score_plan = plan
            if plan == "remote":
                out = gather_blocks(out.to_local(), out.device_mesh, out.placements)
            return out.cpu().numpy()
        self._last_score_plan = "serial"
        return self.module.predict(self.params, xs).cpu().numpy()

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.argmax(self.predict_proba(X), axis=1)

    def score(self, X: np.ndarray, Y: np.ndarray) -> float:
        yhat = self.predict(X)
        y = np.argmax(np.asarray(Y), axis=1) if np.asarray(Y).ndim == 2 else np.asarray(Y)
        return float(np.mean(yhat == y))
