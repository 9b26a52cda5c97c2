"""Loss layers, SystemML ``nn/layers/*_loss.dml`` style: forward returns the
scalar loss, backward returns dScores. Port of ``repro/nn/loss.py``."""

from __future__ import annotations

import torch


class cross_entropy_loss:
    """Expects probabilities (post-softmax), one-hot targets — exactly
    SystemML's nn/layers/cross_entropy_loss.dml."""

    eps = 1e-10

    @staticmethod
    def forward(probs, y):
        n = probs.shape[0]
        return -(y * torch.log(probs + cross_entropy_loss.eps)).sum() / n

    @staticmethod
    def backward(probs, y):
        n = probs.shape[0]
        return -(y / (probs + cross_entropy_loss.eps)) / n


class softmax_cross_entropy:
    """Fused logits->loss (numerically stable; used by the big models)."""

    @staticmethod
    def forward(logits, y):
        n = logits.shape[0]
        z = logits - logits.amax(dim=1, keepdim=True)
        lse = torch.log(torch.exp(z).sum(dim=1, keepdim=True))
        return -(y * (z - lse)).sum() / n

    @staticmethod
    def backward(logits, y):
        n = logits.shape[0]
        z = logits - logits.amax(dim=1, keepdim=True)
        p = torch.exp(z) / torch.exp(z).sum(dim=1, keepdim=True)
        return (p - y) / n


class l2_loss:
    @staticmethod
    def forward(pred, y):
        n = pred.shape[0]
        return 0.5 * ((pred - y) ** 2).sum() / n

    @staticmethod
    def backward(pred, y):
        n = pred.shape[0]
        return (pred - y) / n


class log_loss:
    eps = 1e-10

    @staticmethod
    def forward(pred, y):
        n = pred.shape[0]
        e = log_loss.eps
        return -(y * torch.log(pred + e) + (1 - y) * torch.log(1 - pred + e)).sum() / n

    @staticmethod
    def backward(pred, y):
        n = pred.shape[0]
        e = log_loss.eps
        return (-(y / (pred + e)) + (1 - y) / (1 - pred + e)) / n


class l2_reg:
    @staticmethod
    def forward(w, lam):
        return 0.5 * lam * (w * w).sum()

    @staticmethod
    def backward(w, lam):
        return lam * w


class l1_reg:
    @staticmethod
    def forward(w, lam):
        return lam * w.abs().sum()

    @staticmethod
    def backward(w, lam):
        return lam * torch.sign(w)
