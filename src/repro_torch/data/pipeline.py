"""Data pipeline (port of ``repro/data/pipeline.py``).

SystemML consumes data "generated as part of the big data pipeline" —
NumPy arrays flow into Keras2DML's ``fit(X, Y)``. Here: deterministic
synthetic corpora (token streams, classification matrices, modality
embeddings) made on the host with numpy, byte-identical to the reference's
for the same arguments, and :func:`make_batch`, which hands one batch to a
torch device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.config import InputShape, ModelConfig


@dataclass
class TokenDatasetSpec:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    """Deterministic synthetic language-modelling stream: a noisy order-2
    Markov chain over the vocab, so models can actually reduce loss on it
    (pure-uniform tokens would pin xent at log V)."""

    def __init__(self, spec: TokenDatasetSpec):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        v = spec.vocab_size
        self._shift = int(rng.integers(1, max(2, min(v, 97))))
        self._noise = 0.15

    def batch(self, step: int, batch_size: Optional[int] = None) -> Dict[str, np.ndarray]:
        s = self.spec
        b = batch_size or s.global_batch
        rng = np.random.default_rng((s.seed, step))
        first = rng.integers(0, s.vocab_size, (b, 1))
        toks = [first]
        for _t in range(s.seq_len):
            prev = toks[-1]
            nxt = (prev * 31 + self._shift) % s.vocab_size
            noise = rng.random((b, 1)) < self._noise
            rand = rng.integers(0, s.vocab_size, (b, 1))
            toks.append(np.where(noise, rand, nxt))
        seq = np.concatenate(toks, axis=1).astype(np.int32)  # (b, S+1)
        return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class SyntheticClassification:
    """(X, Y) design-matrix data for the paper's own demos (softmax
    classifier / LeNet): a random linear teacher, optionally sparsified —
    SystemML's sparse-input regime."""

    def __init__(self, num_features: int, num_classes: int, seed: int = 0,
                 density: float = 1.0):
        self.d, self.k, self.seed, self.density = num_features, num_classes, seed, density
        rng = np.random.default_rng(seed)
        self.teacher = rng.standard_normal((num_features, num_classes))

    def batch(self, n: int, step: int = 0):
        rng = np.random.default_rng((self.seed, step, 1))
        x = rng.standard_normal((n, self.d))
        if self.density < 1.0:
            mask = rng.random((n, self.d)) < self.density
            x = x * mask
        y = np.argmax(x @ self.teacher + 0.1 * rng.standard_normal((n, self.k)), axis=1)
        onehot = np.eye(self.k, dtype=np.float32)[y]
        return x.astype(np.float32), onehot


def make_batch(model: ModelConfig, shape: InputShape, step: int = 0,
               batch_override: Optional[int] = None,
               seq_override: Optional[int] = None,
               dtype: torch.dtype = torch.bfloat16,
               device="cuda") -> Dict[str, torch.Tensor]:
    """One batch for any arch and shape, made on the host and moved to
    ``device``: int32 ``tokens`` and ``targets`` (B, S), and for a vision or
    encoder-decoder arch its ``patch_embeds`` or ``frames`` in ``dtype``."""
    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len
    # fixed dataset seed: the Markov rule is a property of the corpus, the
    # step only selects the batch window
    lm = SyntheticLM(TokenDatasetSpec(model.vocab_size, s, b, seed=0))
    batch = {k: torch.from_numpy(v).to(device) for k, v in lm.batch(step, b).items()}
    rng = np.random.default_rng((7, step))
    if model.frontend == "vision":
        batch["patch_embeds"] = _host_float(
            rng.standard_normal((b, model.num_frontend_tokens, model.d_model)), dtype, device)
    if model.is_encdec:
        batch["frames"] = _host_float(
            rng.standard_normal((b, model.encoder_seq, model.d_model)), dtype, device)
    return batch


def _host_float(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """float64 host data rounded once to ``dtype``, as ``jnp.asarray(arr,
    dtype=...)`` rounds it."""
    return torch.from_numpy(arr).to(dtype).to(device)
