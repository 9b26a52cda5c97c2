"""Sparsity-aware operator selection (paper §3, "Sparse Operations"); port
of ``repro/core/sparsity.py``.

SystemML "maintains the number of nonzeros for each intermediate matrix,
decides upon dense or sparse formats, and selects appropriate runtime
operators for combinations of dense and sparse inputs", including four
physical convolution operators (dense/sparse input x dense/sparse filter):

* :class:`MatrixCharacteristics` — dims + nnz metadata (SystemML's
  MatrixCharacteristics);
* :func:`select_format` — the dense/sparse decision with SystemML's
  sparsity threshold (< 0.4);
* CSR-lite sparse matrices with a *static* nnz capacity (the reference pads
  to a capacity and masks, as JAX needs static shapes; the port keeps the
  same layout so the two hold the same matrices): :class:`CSRMatrix`,
  :func:`to_csr`, :func:`csr_to_dense`, and :func:`spmm`, the sparse x
  dense product as a gather of rows of the dense operand and a scatter-add
  (``index_add_``) into the output rows — the reference's
  ``.at[rows].add``, with no library sparse kernel;
* :func:`select_matmul_operator` / :func:`select_conv_operator` — the
  operator-variant dispatch tables, :func:`matmul_auto` (the format-
  dispatched product, with the reference's operator names) and
  :func:`sparse_flops_matmul`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

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


# ---------------------------------------------------------------------------
# CSR-lite: static-capacity sparse matrices
# ---------------------------------------------------------------------------


@dataclass
class CSRMatrix:
    """Padded CSR with a static nnz capacity (masked by ``valid``): the
    stored values with their column and row indices; ``shape`` is static
    metadata — SystemML's sparse MatrixBlock role."""

    values: torch.Tensor    # (capacity,)
    col_idx: torch.Tensor   # (capacity,) int32
    row_idx: torch.Tensor   # (capacity,) int32  (row of each stored value)
    valid: torch.Tensor     # (capacity,) bool
    shape: Tuple[int, int]

    @property
    def nnz_capacity(self) -> int:
        return self.values.shape[0]


def to_csr(x, capacity: Optional[int] = None) -> CSRMatrix:
    """The nonzeros of a 2-D array or tensor in row-major order, padded to
    ``capacity`` (default: nnz, at least 1), on the tensor's device (the
    CPU for an array)."""
    device = x.device if torch.is_tensor(x) else torch.device("cpu")
    xn = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    r, c = np.nonzero(xn)
    vals = xn[r, c]
    nnz = vals.shape[0]
    cap = capacity or max(1, nnz)
    if nnz > cap:
        raise ValueError(f"nnz {nnz} exceeds capacity {cap}")
    pad = cap - nnz

    def dev(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    return CSRMatrix(
        values=dev(np.pad(vals, (0, pad)).astype(xn.dtype)),
        col_idx=dev(np.pad(c, (0, pad)).astype(np.int32)),
        row_idx=dev(np.pad(r, (0, pad)).astype(np.int32)),
        valid=dev(np.pad(np.ones(nnz, bool), (0, pad))),
        shape=(xn.shape[0], xn.shape[1]),
    )


def csr_to_dense(a: CSRMatrix) -> torch.Tensor:
    out = torch.zeros(a.shape, dtype=a.values.dtype, device=a.values.device)
    vals = torch.where(a.valid, a.values, torch.zeros_like(a.values))
    flat = a.row_idx.long() * a.shape[1] + a.col_idx.long()
    return out.view(-1).index_add_(0, flat, vals).view(a.shape)


def spmm(a: CSRMatrix, b: torch.Tensor) -> torch.Tensor:
    """Sparse (CSR-lite) x dense product: each stored value scales the row
    of ``b`` its column names, and the scaled rows are added into the
    output rows of their own rows (``index_add_``).

    FLOPs are O(nnz * ncols(b)) — the "reduces the number of floating point
    operations" claim of the paper."""
    vals = torch.where(a.valid, a.values, torch.zeros_like(a.values)).to(b.dtype)
    rows_of_b = b[a.col_idx.long(), :] * vals[:, None]          # (cap, n)
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=b.dtype, device=b.device)
    return out.index_add_(0, a.row_idx.long(), rows_of_b)


def matmul_auto(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, str]:
    """Format-dispatched matmul: the SystemML operator-selection path.
    Returns the product and the operator's name."""
    mca, mcb = characteristics(a), characteristics(b)
    op = select_matmul_operator(mca, mcb)
    if op == "matmul_sparse_dense":
        return spmm(to_csr(a), b), op
    if op == "matmul_dense_sparse":
        # A @ B = (B^T @ A^T)^T with B^T sparse
        return spmm(to_csr(b.T), a.T).T, op
    if op == "matmul_sparse_sparse":
        # SystemML executes sparse-sparse via sparse-left iteration; the
        # left operand stays sparse and the right is dense
        return spmm(to_csr(a), b), op
    return a @ b, op


def sparse_flops_matmul(a: MatrixCharacteristics, b: MatrixCharacteristics) -> int:
    """Worst-case FLOP estimate under the selected operator (sparse-safe)."""
    op = select_matmul_operator(a, b)
    dense = 2 * a.nrows * a.ncols * b.ncols
    if op == "matmul_sparse_dense" or op == "matmul_sparse_sparse":
        nnz = a.cells if a.nnz < 0 else a.nnz
        return 2 * nnz * b.ncols
    if op == "matmul_dense_sparse":
        nnz = b.cells if b.nnz < 0 else b.nnz
        return 2 * nnz * a.nrows
    return dense
