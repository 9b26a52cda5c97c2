"""Sparsity-aware operator selection (paper §3, "Sparse Operations"); port
of the format-decision half of ``repro/core/sparsity.py``.

SystemML "maintains the number of nonzeros for each intermediate matrix,
decides upon dense or sparse formats, and selects appropriate runtime
operators for combinations of dense and sparse inputs", including four
physical convolution operators (dense/sparse input x dense/sparse filter):

* :class:`MatrixCharacteristics` — dims + nnz metadata (SystemML's
  MatrixCharacteristics);
* :func:`select_format` — the dense/sparse decision with SystemML's
  sparsity threshold (< 0.4);
* :func:`select_matmul_operator` / :func:`select_conv_operator` — the
  operator-variant dispatch tables.

The CSR matrices, ``spmm`` and ``matmul_auto`` come in a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# SystemML's format decision threshold: matrices with sparsity below this are
# stored sparse (MatrixBlock.SPARSITY_TURN_POINT = 0.4).
SPARSITY_TURN_POINT = 0.4
# Minimum size for the sparse format to pay off (tiny matrices stay dense).
SPARSE_MIN_CELLS = 4096


@dataclass(frozen=True)
class MatrixCharacteristics:
    nrows: int
    ncols: int
    nnz: int = -1  # -1 = unknown -> assume worst-case dense

    @property
    def cells(self) -> int:
        return self.nrows * self.ncols

    @property
    def density(self) -> float:
        if self.nnz < 0:
            return 1.0
        return self.nnz / max(1, self.cells)

    def dense_bytes(self, dtype_bytes: int = 4) -> int:
        return self.cells * dtype_bytes

    def sparse_bytes(self, dtype_bytes: int = 4) -> int:
        """CSR: values + col indices (int32) + row pointers."""
        nnz = self.cells if self.nnz < 0 else self.nnz
        return nnz * (dtype_bytes + 4) + (self.nrows + 1) * 4

    def out_of(self, x: torch.Tensor) -> "MatrixCharacteristics":
        return MatrixCharacteristics(x.shape[0], x.shape[1], int((x != 0).sum()))


def characteristics(x) -> MatrixCharacteristics:
    """Characteristics of a 2-D numpy array or tensor (counted on the host
    for an array, on the tensor's device for a tensor)."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
    return MatrixCharacteristics(x.shape[0], x.shape[1], int((x != 0).sum()))


def select_format(mc: MatrixCharacteristics) -> str:
    """'sparse' iff density < 0.4 and big enough — SystemML's rule."""
    if mc.cells < SPARSE_MIN_CELLS:
        return "dense"
    return "sparse" if mc.density < SPARSITY_TURN_POINT else "dense"


def select_matmul_operator(a: MatrixCharacteristics, b: MatrixCharacteristics) -> str:
    fa, fb = select_format(a), select_format(b)
    return f"matmul_{fa}_{fb}"


def select_conv_operator(x: MatrixCharacteristics, w: MatrixCharacteristics) -> str:
    """The paper's four physical conv operators."""
    fx, fw = select_format(x), select_format(w)
    return f"conv2d_{fx}_{fw}"
