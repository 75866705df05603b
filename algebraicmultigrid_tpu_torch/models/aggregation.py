"""Smoothed-aggregation AMG setup driver + tentative prolongator fitting.

Parity with AlgebraicMultigrid.jl ``src/aggregation.jl:66-240``: per level —
symmetric strength → standard aggregation → candidate improvement (relax
``A·B ≈ 0``) → ``fit_candidates`` tentative prolongator → Jacobi prolongator
smoothing → Galerkin ``RAP`` — with the BSR fast-path flag set for all levels
after the first (aggregation.jl:153) and near-null-space ``B`` threaded down
the hierarchy.

``fit_candidates``:

* vector ``B``  — per-aggregate normalisation; coarse candidate = column
  norms, zero-guarded (aggregation.jl:161-193);
* matrix ``B``  — per-aggregate dense QR; Q scattered into the tentative
  prolongator at column offset ``agg·m``, R stacked into the coarse
  candidate block (aggregation.jl:195-230).  Implemented as **size-batched**
  QR: aggregates are grouped by size and factorised with one batched
  ``np.linalg.qr`` per group (no per-aggregate Python loop).

Contracts pinned by reference tests and re-pinned here: ``B ≈ Q·R`` and
``B ≈ Q·(Qᵀ·B)`` (test/nns_test.jl:95-106, test/sa_tests.jl:204-217).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..config import GaussSeidel, Jacobi
from ..ops.sparse import as_csc, as_csr
from ..utils.symmetry import HermitianSymmetry
from .aggregate import StandardAggregation
from .coarse import default_coarse_solver
from .multilevel import Level, MultiLevel
from .prolongation_smooth import JacobiProlongation
from .relax import setup_smoother_host
from .strength import SymmetricStrength

__all__ = ["smoothed_aggregation", "fit_candidates"]


def fit_candidates(AggOp, B, tol: float = 1e-10):
    """Fit near-null-space candidates into a tentative prolongator.

    Returns ``(Q, B_coarse)`` with ``Q`` sparse (n_fine × n_coarse).
    """
    B = np.asarray(B)
    if B.ndim == 1:
        return _fit_candidates_vector(AggOp, B, tol)
    return _fit_candidates_matrix(AggOp, B, tol)


def _fit_candidates_vector(AggOp, B, tol):
    # aggregation.jl:161-193
    A = as_csc(sp.csr_matrix(AggOp).T)  # n_fine × n_agg
    n_fine, n_agg = A.shape
    dtype = B.dtype if B.dtype.kind in "fc" else np.float64

    vals = B[A.indices].astype(dtype)
    cols = np.repeat(np.arange(n_agg), np.diff(A.indptr))
    sq = np.zeros(n_agg, dtype=dtype)
    np.add.at(sq, cols, vals * vals)
    norms = np.sqrt(sq)

    nonzero = norms > tol * norms  # == (norms > 0), preserved quirk
    R = np.where(nonzero, norms, 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(nonzero, 1.0 / np.where(nonzero, norms, 1), 0.0)
    Q = sp.csc_matrix((vals * scale[cols], A.indices.copy(), A.indptr.copy()), shape=A.shape)
    return as_csr(Q), R


def _fit_candidates_matrix(AggOp, B, tol):
    # aggregation.jl:195-230, vectorised by aggregate-size groups.
    A = as_csc(sp.csr_matrix(AggOp).T)  # n_fine × n_agg
    n_fine, n_agg = A.shape
    m = B.shape[1]
    n_coarse = m * n_agg
    dtype = B.dtype if B.dtype.kind in "fc" else np.float64

    sizes = np.diff(A.indptr)
    R = np.zeros((n_coarse, m), dtype=dtype)

    rows_acc, cols_acc, vals_acc = [], [], []
    for s in np.unique(sizes):
        aggs = np.flatnonzero(sizes == s)
        if s == 0:
            continue
        # Member rows of each aggregate in this size group: (n_group, s)
        starts = A.indptr[aggs]
        member = A.indices[starts[:, None] + np.arange(s)[None, :]]
        blocks = B[member].astype(dtype)  # (n_group, s, m)
        Qb, Rb = np.linalg.qr(blocks)  # reduced: Q (g, s, r'), R (g, r', m)
        r = min(int(s), m)
        Qb = Qb[:, :, :r]
        Rb = Rb[:, :r, :]

        offs = aggs * m  # coarse column offset per aggregate
        # Scatter Q entries with |val| >= tol (aggregation.jl:218-223).
        g = aggs.size
        rows = np.broadcast_to(member[:, :, None], (g, s, r))
        cols = offs[:, None, None] + np.broadcast_to(
            np.arange(r)[None, None, :], (g, s, r)
        )
        keep = np.abs(Qb) >= tol
        rows_acc.append(rows[keep])
        cols_acc.append(cols[keep])
        vals_acc.append(Qb[keep])
        # Coarse candidate rows offset..offset+r get the R factor.
        ridx = (offs[:, None] + np.arange(r)[None, :]).ravel()
        R[ridx] = Rb.reshape(g * r, m)

    if rows_acc:
        Q = sp.coo_matrix(
            (
                np.concatenate(vals_acc),
                (np.concatenate(rows_acc), np.concatenate(cols_acc)),
            ),
            shape=(n_fine, n_coarse),
        ).tocsr()
    else:
        Q = sp.csr_matrix((n_fine, n_coarse), dtype=dtype)
    Q.sum_duplicates()
    Q.sort_indices()
    return Q, R


def smoothed_aggregation(
    A,
    *,
    B=None,
    symmetry=HermitianSymmetry(),
    strength=SymmetricStrength(),
    aggregate=StandardAggregation(),
    smooth=JacobiProlongation(4.0 / 3.0),
    presmoother=GaussSeidel(),
    postsmoother=GaussSeidel(),
    improve_candidates=GaussSeidel(iter=4),
    max_levels: int = 10,
    max_coarse: int = 10,
    diagonal_dominance: bool = False,  # accepted, unused (aggregation.jl:78-79)
    keep: bool = False,  # accepted, unused
    verbose: bool = False,
    coarse_solver=None,
    blocksize: int = 1,
    **kwargs,
) -> MultiLevel:
    """Build a smoothed-aggregation hierarchy (aggregation.jl:66-114)."""
    from .lattice import LatticeMatrix
    from .structured import StructuredAggregation

    if isinstance(A, LatticeMatrix):
        if (
            isinstance(aggregate, (StructuredAggregation, type(None)))
            or isinstance(aggregate, StandardAggregation)
        ) and isinstance(strength, SymmetricStrength):
            from .fastsetup import structured_smoothed_aggregation

            agg = aggregate if isinstance(aggregate, StructuredAggregation) else None
            return structured_smoothed_aggregation(
                A,
                B=B,
                aggregate=agg,
                strength=strength,
                symmetry=symmetry,
                smooth=smooth,
                presmoother=presmoother,
                postsmoother=postsmoother,
                improve_candidates=improve_candidates
                if isinstance(improve_candidates, Jacobi)
                else None,
                max_levels=max_levels,
                max_coarse=max_coarse,
                coarse_solver=coarse_solver,
                **kwargs,
            )
        A = A.tocsr()  # non-structured policies: assemble + generic path
    A = as_csc(A)
    n = A.shape[0]
    dtype = A.dtype
    if B is None:
        B = np.ones(n, dtype=dtype)
    else:
        B = np.array(B, copy=True)
    assert B.shape[0] == n, "near-null-space rows must match A"
    if coarse_solver is None:
        coarse_solver = default_coarse_solver(A)

    levels = []
    bsr_flag = False
    B_per_level = [np.array(B, copy=True)]  # pre-improvement B per level
    while len(levels) + 1 < max_levels and A.shape[0] > max_coarse:
        A, B, bsr_flag, stop = _extend_hierarchy_sa(
            levels,
            strength,
            aggregate,
            smooth,
            improve_candidates,
            A,
            B,
            presmoother,
            postsmoother,
            symmetry,
            bsr_flag,
        )
        if stop:
            break
        if len(B_per_level) == len(levels):
            B_per_level.append(np.array(B, copy=True))

    cs = coarse_solver(A)
    ml = MultiLevel(levels, as_csr(A), cs, symmetry=symmetry)
    # per-level near-null-space candidates (pre-improvement), consumed by the
    # structured fast path to seed the generic tail (models/fastsetup.py)
    ml._B_per_level = B_per_level
    if verbose:
        print(ml)
    return ml


def _extend_hierarchy_sa(
    levels,
    strength,
    aggregate,
    smooth,
    improve_candidates,
    A,
    B,
    presmoother,
    postsmoother,
    symmetry,
    bsr_flag,
):
    """One SA coarsening step (aggregation.jl:116-157)."""
    # 1. strength (adjoint first for non-Hermitian, aggregation.jl:122-126)
    Amat = A if isinstance(symmetry, HermitianSymmetry) else as_csc(A.T)
    if isinstance(strength, SymmetricStrength):
        S, _T = strength(Amat, bsr_flag)
    else:
        S, _T = strength(Amat)

    # 2. aggregation
    AggOp = aggregate(S)
    if AggOp.shape[0] == 0:
        return A, B, bsr_flag, True

    # 3. candidate improvement: relax A·B ≈ 0 (aggregation.jl:135-136)
    A_csr = as_csr(A)
    if improve_candidates is not None:
        b0 = np.zeros(B.shape, dtype=A.dtype)
        cache = setup_smoother_host(improve_candidates, A_csr, symmetry)
        cache.smooth(B, b0)

    # 4. tentative prolongator + coarse candidates
    T, B_coarse = fit_candidates(AggOp, B)

    # 5. prolongator smoothing; R = Pᴴ (aggregation.jl:139-142,158-159)
    P = smooth(A_csr, T, S, B_coarse)
    if P.shape[1] == 0:
        return A, B, True, True
    R = as_csr(P.conj().T if np.iscomplexobj(P.dtype.type(0)) else P.T)

    # 6. Galerkin product
    RAP = as_csc((R @ (A_csr @ P)).tocsc())

    level = Level(
        A=A_csr,
        P=as_csr(P),
        R=R,
        presmoother_config=presmoother,
        postsmoother_config=postsmoother,
        symmetry=symmetry,
    )
    # Factored-prolongator stash: with the default LocalWeighting degree-1
    # Jacobi smoothing (aggregation.jl:10-17,26-47), P ≡ (I − diag(s)·A)·T
    # with s = ω·D̃⁻¹ exactly as built above — the device kernel tier can
    # then apply P/R from T + s + the already-resident A stencil instead of
    # streaming materialised P/R coefficient planes (P has (2k+1)² offsets,
    # R = Pᵀ up to (3k)²; T has one).
    if isinstance(smooth, JacobiProlongation) and isinstance(
        symmetry, HermitianSymmetry
    ) and not np.iscomplexobj(A_csr.data):
        D = np.asarray(np.abs(A_csr).sum(axis=1)).ravel()
        level.T_tent = as_csr(T)
        level.psmooth_scale = smooth.omega * np.where(
            D != 0, 1.0 / np.where(D != 0, D, 1.0), 0.0
        )
    levels.append(level)
    return RAP, B_coarse, True, False
