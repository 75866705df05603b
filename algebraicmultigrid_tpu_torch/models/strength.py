"""Strength-of-connection kernels (hierarchy setup, host tier).

Behavioural parity with AlgebraicMultigrid.jl ``src/strength.jl``:

* :class:`Classical` — classical (Ruge-Stüben) strength, θ default 0.25
  (strength.jl:2-37).  Operating column-wise on ``At`` (CSC) ≡ row-wise on A.
* :class:`SymmetricStrength` — symmetric strength, θ default 0.0
  (strength.jl:72-122), including the BSR fast path for coarse SA levels
  (strength.jl:81-84) and the explicit complex rejection (strength.jl:124-126).

The reference runs scalar per-entry Julia loops; here every step is a
vectorised numpy segment operation over the CSC arrays (O(nnz), C speed) —
the same math, restructured for array execution.  These kernels are
embarrassingly row/column-parallel (survey §7) and are the first candidates
for a jitted on-device variant in later rounds.

Protocol (strength.jl:7): calling an instance on a matrix returns ``(S, T)``
where ``S`` is the strength graph consumed by splitting/aggregation and ``T``
the companion thresholded matrix used by interpolation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from ..ops.sparse import as_csc

__all__ = ["Classical", "SymmetricStrength"]


def _col_ids(M: sp.csc_matrix) -> np.ndarray:
    """Column id of every stored entry of a CSC matrix."""
    return np.repeat(np.arange(M.shape[1]), np.diff(M.indptr))


def _segment_max(values: np.ndarray, seg: np.ndarray, n: int) -> np.ndarray:
    """max over segments with identity 0 (mirrors find_max/find_max_off_diag
    which start their accumulator at zero, strength.jl:39-59)."""
    out = np.zeros(n, dtype=values.dtype)
    np.maximum.at(out, seg, values)
    return out


def _colmax_csc(values: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    """Per-column max over CSC segments, identity 0 (fast reduceat path)."""
    n = len(indptr) - 1
    out = np.zeros(n, dtype=values.dtype)
    counts = np.diff(indptr)
    nonempty = counts > 0
    if not nonempty.any():
        return out
    starts = indptr[:-1][nonempty]
    res = np.maximum.reduceat(values, starts)
    out[nonempty] = np.maximum(res, 0)
    return out


def _scale_cols_by_largest_entry(M: sp.csc_matrix) -> sp.csc_matrix:
    """Divide every column by its largest (signed, floored at 0) stored entry
    — strength.jl:61-70."""
    m = _colmax_csc(M.data, M.indptr)
    cols = _col_ids(M)
    with np.errstate(divide="ignore", invalid="ignore"):
        M.data = M.data / m[cols]
    return M


@dataclasses.dataclass(frozen=True)
class Classical:
    """Classical strength of connection with threshold ``theta``."""

    theta: float = 0.25

    def __call__(self, At):
        At = as_csc(At)
        T = At.copy()
        if np.iscomplexobj(T.data):
            # `real(copy(At))` (strength.jl:12)
            T = sp.csc_matrix(
                (T.data.real.copy(), T.indices.copy(), T.indptr.copy()),
                shape=T.shape,
            )

        cols = _col_ids(T)
        rows = T.indices
        off_diag = rows != cols

        absval = np.abs(T.data)
        max_off = _colmax_csc(np.where(off_diag, absval, 0.0), T.indptr)
        threshold = self.theta * max_off

        keep = absval >= threshold[cols]
        # Off-diagonal: |val| if kept, else 0.  Diagonal kept untouched
        # (strength.jl:14-30 only rewrites row != i entries).
        T.data = np.where(off_diag, np.where(keep, absval, 0.0), T.data)
        T.eliminate_zeros()

        _scale_cols_by_largest_entry(T)
        S = as_csc(T.T)  # materialised transpose (strength.jl:36 returns adjoint(T))
        return S, T


@dataclasses.dataclass(frozen=True)
class SymmetricStrength:
    """Symmetric strength: keep (i,j) iff A_ij² ≥ θ²·|A_ii|·|A_jj|."""

    theta: float = 0.0

    def __call__(self, A, bsr_flag: bool = False):
        A = as_csc(A)
        if np.iscomplexobj(A.data):
            raise ValueError(
                "Symmetric strength not implemented for complex matrices."
            )  # strength.jl:124-126

        if bsr_flag and self.theta == 0:
            # Coarse-SA fast path: sparsity pattern with unit values
            # (strength.jl:81-84).
            S = sp.csc_matrix(
                (np.ones_like(A.data), A.indices.copy(), A.indptr.copy()),
                shape=A.shape,
            )
            return S, S

        S = A.copy()
        cols = _col_ids(S)
        rows = S.indices

        # diags[i] = |Σ diagonal entries of column i| (strength.jl:91-101);
        # canonical CSC has deduplicated entries so .diagonal() is the sum.
        diags = np.abs(S.diagonal())
        on_diag = rows == cols

        drop = (~on_diag) & (S.data**2 < (self.theta**2) * diags[cols] * diags[rows])
        S.data = np.where(drop, 0.0, S.data)
        S.eliminate_zeros()

        S.data = np.abs(S.data)
        _scale_cols_by_largest_entry(S)
        return S, S
