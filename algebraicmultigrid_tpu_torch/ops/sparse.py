"""Sparse containers: host helpers and the device ELL format.

Two tiers:

* Host tier — ``scipy.sparse`` CSC/CSR matrices drive the run-once
  hierarchy setup (the reference stores everything as Julia
  ``SparseMatrixCSC``; scipy's CSC has the identical layout).
* Device tier — :class:`ELL` is a padded sparse-row format of torch
  tensors: every row is padded to the same width with ``(col=0, val=0)``
  slots, so the SpMV (``ops/spmv.py``) is one gather, multiply and row sum.
  It is the gather fallback of the device lowering; lattice levels lower to
  Lat2D planes (``ops/lattice_op.py``), the others to the formats of
  ``ops/banded.py`` and ``ops/bsg.py`` where they fit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["ELL", "as_csr", "as_csc", "ell_from_csr", "ell_to_scipy", "round_up", "np_dtype"]


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def as_csr(A: Any) -> sp.csr_matrix:
    """Coerce any array-like / scipy / lattice matrix to canonical CSR
    (sorted, no dupes).  Symbolic lattice operators materialise here (the
    host tier's prerogative; the device tier lowers them without CSR)."""
    if sp.issparse(A):
        M = A.tocsr()
    elif hasattr(A, "tocsr"):
        M = sp.csr_matrix(A.tocsr())
    else:
        M = sp.csr_matrix(np.asarray(A))
    M.sum_duplicates()
    M.sort_indices()
    return M


def as_csc(A: Any) -> sp.csc_matrix:
    """Coerce to canonical CSC (the reference's native layout)."""
    if sp.issparse(A):
        M = A.tocsc()
    elif hasattr(A, "tocsc"):
        M = sp.csc_matrix(A.tocsc())
    else:
        M = sp.csc_matrix(np.asarray(A))
    M.sum_duplicates()
    M.sort_indices()
    return M


@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded sparse-row (ELLPACK) matrix.

    ``data[i, k]`` / ``cols[i, k]`` hold the k-th stored entry of row ``i``;
    rows are padded with ``(col=0, val=0)`` up to ``width`` and the row
    count up to a multiple of ``row_pad``.  ``shape`` is the logical
    (n_rows, n_cols) and ``nnz`` the logical number of stored entries."""

    data: torch.Tensor  # [rows_padded, width]
    cols: torch.Tensor  # int64 [rows_padded, width]
    shape: Tuple[int, int]
    nnz: int

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def rows_padded(self) -> int:
        return self.data.shape[0]


def ell_from_csr(A: Any, dtype: torch.dtype, device, row_pad: int = 8, min_width: int = 1) -> ELL:
    """Convert a host sparse matrix to the padded device :class:`ELL` format
    (the JAX package's ``ell_from_csr`` layout)."""
    M = as_csr(A)
    n_rows, n_cols = M.shape
    counts = np.diff(M.indptr)
    width = max(int(counts.max()) if counts.size else 0, min_width)
    rows_padded = max(round_up(max(n_rows, 1), row_pad), row_pad)
    data = np.zeros((rows_padded, width), dtype=np_dtype(dtype))
    cols = np.zeros((rows_padded, width), dtype=np.int64)
    if M.nnz:
        rows = np.repeat(np.arange(n_rows), counts)
        offs = np.arange(M.nnz) - np.repeat(M.indptr[:-1], counts)
        data[rows, offs] = M.data.astype(data.dtype)
        cols[rows, offs] = M.indices
    return ELL(
        data=torch.as_tensor(data, device=device),
        cols=torch.as_tensor(cols, device=device),
        shape=(n_rows, n_cols),
        nnz=int(M.nnz),
    )


def ell_to_scipy(E: ELL) -> sp.csr_matrix:
    """Lossy inverse of :func:`ell_from_csr` (drops explicit zeros)."""
    n_rows, n_cols = E.shape
    data = E.data[:n_rows].cpu().numpy()
    cols = E.cols[:n_rows].cpu().numpy()
    rows = np.repeat(np.arange(n_rows), E.width)
    M = sp.coo_matrix((data.ravel(), (rows, cols.ravel())), shape=(n_rows, n_cols)).tocsr()
    M.eliminate_zeros()
    return M
