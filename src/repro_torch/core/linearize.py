"""Tensor linearization (paper §3, "Tensor Representation"); port of
``repro/core/linearize.py``.

SystemML's primary data structure is a 2-D matrix; a tensor of shape
[N, C, H, W] is represented as a matrix with N rows and C*H*W columns.
The ``repro_torch.nn`` library consumes linearized matrices exactly like
SystemML's NN library, so every layer's forward/backward is a matrix
program.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def linearize(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """[N, d1, ..., dk] -> ((N, d1*...*dk), trailing_shape)."""
    n = x.shape[0]
    trailing = tuple(x.shape[1:])
    return x.reshape(n, -1) if x.dim() != 2 else x, trailing


def delinearize(x2d: torch.Tensor, trailing: Sequence[int]) -> torch.Tensor:
    """(N, prod(trailing)) -> [N, *trailing]."""
    n, cols = x2d.shape
    expect = math.prod(trailing)
    if cols != expect:
        raise ValueError(f"cannot delinearize {tuple(x2d.shape)} into {tuple(trailing)}")
    return x2d.reshape((n, *trailing))


def linearized_cols(trailing: Sequence[int]) -> int:
    return math.prod(trailing)


def conv2d_out_hw(h: int, w: int, kernel: int, stride: int, pad: int) -> Tuple[int, int]:
    """Output spatial dims for a square-kernel conv on linearized input."""
    ho = (h + 2 * pad - kernel) // stride + 1
    wo = (w + 2 * pad - kernel) // stride + 1
    return ho, wo
