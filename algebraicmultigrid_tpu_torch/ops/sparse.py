"""Host sparse helpers for the setup tier.

The host tier drives the run-once hierarchy setup on ``scipy.sparse``
CSC/CSR matrices (the reference stores everything as Julia
``SparseMatrixCSC``; scipy's CSC has the identical layout).  The JAX
package's device ELL format is not part of this package: the port's device
tier lowers lattice levels straight to Lat2D planes (``ops/lattice_op.py``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import scipy.sparse as sp

__all__ = ["as_csr", "as_csc", "round_up"]


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
