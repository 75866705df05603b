"""Ruge-Stüben C/F splitting (hierarchy setup, host tier).

Behavioural parity with AlgebraicMultigrid.jl ``src/splitting.jl``: the classical
first-pass greedy splitting driven by a bucket queue over
λ(i) = #{nodes strongly coupled to i}, with O(1) interval swaps for the
λ increments/decrements (splitting.jl:25-159).  Deterministic — the exact
0/1 outputs are pinned by the reference tests (test/runtests.jl:36-50) and by
ours, so tie-breaking order is reproduced exactly (nodes bucket-sorted by λ
in index order; the highest-index node among max-λ nodes is picked first).

This greedy algorithm is inherently sequential (survey §2.4 flags it as the
hardest-to-parallelise component).  It runs in the C++ kernel of
``native/amg_setup.cpp``, a copy of the JAX package's — splitting runs once
per level at setup, off the device hot path.

Node states follow splitting.jl:1-3: F=0, C=1, U=2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from ..ops.sparse import as_csc

__all__ = ["RS", "F_NODE", "C_NODE", "U_NODE", "rs_cf_splitting"]

F_NODE = 0
C_NODE = 1
U_NODE = 2


def _remove_diag(S: sp.csc_matrix) -> sp.csc_matrix:
    """Zero and drop the diagonal (splitting.jl:8-18)."""
    S = S.copy()
    cols = np.repeat(np.arange(S.shape[1]), np.diff(S.indptr))
    S.data = np.where(S.indices == cols, 0.0, S.data)
    S.eliminate_zeros()
    return S


@dataclasses.dataclass(frozen=True)
class RS:
    """Classical Ruge-Stüben splitting strategy (splitting.jl:5-23)."""

    def __call__(self, S) -> np.ndarray:
        S = _remove_diag(as_csc(S))
        T = as_csc(S.T)
        return rs_cf_splitting(S, T)


def rs_cf_splitting(S: sp.csc_matrix, T: sp.csc_matrix) -> np.ndarray:
    """First-pass RS splitting over strength graph S (CSC) and its transpose.

    Returns an int array of F_NODE/C_NODE per node.  See module docstring for
    ordering semantics; the kernel mirrors splitting.jl:25-159 (0-based).
    """
    n = S.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)

    from ..native.build import as_i64_ptr, get_native

    lib = get_native()
    Sp64 = np.ascontiguousarray(S.indptr, dtype=np.int64)
    Sj64 = np.ascontiguousarray(S.indices, dtype=np.int64)
    Tp64 = np.ascontiguousarray(T.indptr, dtype=np.int64)
    Tj64 = np.ascontiguousarray(T.indices, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    lib.rs_cf_splitting(
        n, as_i64_ptr(Sp64), as_i64_ptr(Sj64),
        as_i64_ptr(Tp64), as_i64_ptr(Tj64), as_i64_ptr(out),
    )
    return out
