"""Direct interpolation for classical (Ruge-Stüben) AMG — host setup tier.

Behavioural parity with AlgebraicMultigrid.jl ``src/classical.jl:57-189``:
two-pass construction of the restriction R (CSC, coarse rows) whose transpose
is the prolongator P.  C rows get identity weight 1; F rows get direct
interpolation weights  w_ij = |(α or β)/d_i · s_ij|  with α = Σ all-neg /
Σ strong-neg, β = Σ all-pos / Σ strong-pos, including the reference's
fallback lumping into the diagonal when a class is empty
(classical.jl:137-154) and the zero-diagonal guard (classical.jl:155-161).

The reference's per-node scalar loops become numpy segment reductions over
the CSC arrays — one fused O(nnz) pass instead of pass1+pass2 loops.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..ops.sparse import as_csc
from .splitting import C_NODE

__all__ = ["direct_interpolation"]


def direct_interpolation(At: sp.csc_matrix, T: sp.csc_matrix, splitting: np.ndarray):
    """Build (P, R) from the operator ``At`` (CSC), strength companion ``T``
    and the C/F ``splitting``.

    Returns ``(P, R)`` as scipy CSR/CSC matrices with P = Rᵀ
    (classical.jl:64-65).  If there are no C points, P has zero columns and
    the caller stops coarsening (classical.jl:45).
    """
    At = as_csc(At)
    T = as_csc(T)
    n = At.shape[0]
    split = np.asarray(splitting)
    is_C = split == C_NODE

    dtype = At.dtype
    # T with the operator's values on the strength pattern
    # (`T .= At .* T` after unit fill, classical.jl:58-60).
    T_unit = sp.csc_matrix(
        (np.ones(T.nnz, dtype=dtype), T.indices.copy(), T.indptr.copy()),
        shape=T.shape,
    )
    Tv = as_csc(T_unit.multiply(At))

    t_cols = np.repeat(np.arange(n), np.diff(Tv.indptr))
    t_rows = Tv.indices
    sval = Tv.data
    strong_C = is_C[t_rows]

    # Σ strong-pos / strong-neg per column over C entries (classical.jl:107-119)
    def _segsum(mask, vals, idx):
        if np.iscomplexobj(vals):
            return (
                np.bincount(idx[mask], weights=vals.real[mask], minlength=n)
                + 1j * np.bincount(idx[mask], weights=vals.imag[mask], minlength=n)
            ).astype(dtype)
        return np.bincount(idx[mask], weights=vals[mask], minlength=n).astype(dtype)

    neg_mask = np.real(sval) < 0
    sum_strong_neg = _segsum(strong_C & neg_mask, sval, t_cols)
    sum_strong_pos = _segsum(strong_C & ~neg_mask, sval, t_cols)

    # Σ all-pos / all-neg / diag per column of At (classical.jl:120-135)
    a_cols = np.repeat(np.arange(n), np.diff(At.indptr))
    a_rows = At.indices
    aval = At.data
    a_diag_mask = a_rows == a_cols
    a_neg = np.real(aval) < 0

    def _segsum_a(mask):
        if np.iscomplexobj(aval):
            return (
                np.bincount(a_cols[mask], weights=aval.real[mask], minlength=n)
                + 1j * np.bincount(a_cols[mask], weights=aval.imag[mask], minlength=n)
            ).astype(dtype)
        return np.bincount(a_cols[mask], weights=aval[mask], minlength=n).astype(dtype)

    diag = _segsum_a(a_diag_mask)
    sum_all_neg = _segsum_a((~a_diag_mask) & a_neg)
    sum_all_pos = _segsum_a((~a_diag_mask) & ~a_neg)

    # Fallback lumping (classical.jl:137-154): order matters — the β branch
    # may modify diag before the α branch does.
    no_sp = sum_strong_pos == 0
    beta = np.zeros(n, dtype=dtype)
    with np.errstate(divide="ignore", invalid="ignore"):
        beta = np.where(no_sp, 0, np.divide(sum_all_pos, np.where(no_sp, 1, sum_strong_pos)))
    diag = np.where(no_sp & (np.real(diag) >= 0), diag + sum_all_pos, diag)

    no_sn = sum_strong_neg == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = np.where(no_sn, 0, np.divide(sum_all_neg, np.where(no_sn, 1, sum_strong_neg)))
    diag = np.where(no_sn & (np.real(diag) < 0), diag + sum_all_neg, diag)

    # Zero-diagonal guard (classical.jl:155-161): Julia's
    # isapprox(x, 0, atol=eps) with explicit atol has rtol=0, i.e. |x| <= eps.
    real_dtype = np.empty(0, dtype=dtype).real.dtype
    eps = np.finfo(real_dtype).eps
    zdiag = np.abs(np.real(diag)) <= eps
    safe_diag = np.where(zdiag, 1, diag)
    neg_coeff = np.where(zdiag, 0, alpha / safe_diag)
    pos_coeff = np.where(zdiag, 0, beta / safe_diag)

    # Coarse index of each C node: exclusive prefix sum (classical.jl:180-186).
    coarse_id = np.cumsum(is_C) - is_C.astype(np.int64)
    n_coarse = int(is_C.sum())
    if n_coarse == 0:
        P = sp.csr_matrix((n, 0), dtype=dtype)
        R = sp.csr_matrix((0, n), dtype=dtype)
        return P, R

    # F-column entries: one per strong-C entry of Tv in an F column.
    f_entry = strong_C & ~is_C[t_cols]
    coeff = np.where(neg_mask, neg_coeff[t_cols], pos_coeff[t_cols])
    f_vals = np.abs(coeff[f_entry] * sval[f_entry])
    f_rows_R = coarse_id[t_rows[f_entry]]
    f_cols_R = t_cols[f_entry]

    # C-column entries: identity weight (classical.jl:103-105).
    c_nodes = np.flatnonzero(is_C)
    c_rows_R = coarse_id[c_nodes]
    c_cols_R = c_nodes
    c_vals = np.ones(n_coarse, dtype=dtype)

    R = sp.coo_matrix(
        (
            np.concatenate([f_vals, c_vals]),
            (np.concatenate([f_rows_R, c_rows_R]), np.concatenate([f_cols_R, c_cols_R])),
        ),
        shape=(n_coarse, n),
    ).tocsr()
    R.sum_duplicates()
    R.sort_indices()
    P = R.T.tocsr()
    P.sort_indices()
    return P, R
