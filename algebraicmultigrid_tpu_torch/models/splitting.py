"""Ruge-Stüben C/F splitting (hierarchy setup, host tier).

Behavioural parity with AlgebraicMultigrid.jl ``src/splitting.jl``: the classical
first-pass greedy splitting driven by a bucket queue over
λ(i) = #{nodes strongly coupled to i}, with O(1) interval swaps for the
λ increments/decrements (splitting.jl:25-159).  Deterministic — the exact
0/1 outputs are pinned by the reference tests (test/runtests.jl:36-50) and by
ours, so tie-breaking order is reproduced exactly (nodes bucket-sorted by λ
in index order; the highest-index node among max-λ nodes is picked first).

This greedy algorithm is inherently sequential (survey §2.4 flags it as the
hardest-to-parallelise component).  The strategy here:

* this Python/numpy implementation is the semantic reference, and the only
  tier in this package (the JAX package adds an identical-semantics C++
  kernel for large n);
* splitting runs once per level at setup, off the device hot path.

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
    ordering semantics; structure mirrors splitting.jl:25-159 (0-based).
    """
    n = S.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)

    Sp, Sj = S.indptr, S.indices
    Tp, Tj = T.indptr, T.indices

    lam = np.diff(Sp).astype(np.int64)  # λ(i) = |column i of S|

    # Bucket sort nodes by λ. interval_ptr[k] = start slot of bucket λ=k.
    interval_count = np.zeros(n + 1, dtype=np.int64)
    np.add.at(interval_count, lam, 1)
    interval_ptr = np.zeros(n + 1, dtype=np.int64)
    interval_ptr[1:] = np.cumsum(interval_count)[:-1]

    # Stable insertion in node-index order (matches splitting.jl:56-63).
    order = np.argsort(lam, kind="stable")
    index_to_node = order.copy()
    node_to_index = np.empty(n, dtype=np.int64)
    node_to_index[order] = np.arange(n)
    interval_count[:] = 0
    np.add.at(interval_count, lam, 1)

    splitting = np.full(n, U_NODE, dtype=np.int64)
    splitting[lam == 0] = F_NODE  # nobody depends on them (splitting.jl:67-71)

    # Greedy pass: repeatedly pick the (max-λ, max-index) node.
    for top_index in range(n - 1, -1, -1):
        i = index_to_node[top_index]
        lam_i = lam[i]
        interval_count[lam_i] -= 1

        if splitting[i] == F_NODE:
            continue
        splitting[i] = C_NODE

        for j in range(Sp[i], Sp[i + 1]):
            row = Sj[j]
            if splitting[row] != U_NODE:
                continue
            splitting[row] = F_NODE

            # New F point: bump λ of its still-undecided influences
            # (second ring), moving each to the END of its bucket.
            for k in range(Tp[row], Tp[row + 1]):
                rowk = Tj[k]
                if splitting[rowk] != U_NODE:
                    continue
                if lam[rowk] >= n - 1:  # bucket bound guard (splitting.jl:107)
                    continue
                lam_k = lam[rowk]
                old_pos = node_to_index[rowk]
                new_pos = interval_ptr[lam_k] + interval_count[lam_k] - 1

                swap_node = index_to_node[new_pos]
                index_to_node[old_pos] = swap_node
                index_to_node[new_pos] = rowk
                node_to_index[rowk] = new_pos
                node_to_index[swap_node] = old_pos

                lam[rowk] += 1
                interval_count[lam_k] -= 1
                interval_count[lam_k + 1] += 1
                interval_ptr[lam_k + 1] = new_pos

        # New C point: drop λ of its still-undecided influences, moving each
        # to the FRONT of its bucket.
        for j in range(Tp[i], Tp[i + 1]):
            row = Tj[j]
            if splitting[row] != U_NODE:
                continue
            if lam[row] == 0:  # guard (splitting.jl:136)
                continue
            lam_j = lam[row]
            old_pos = node_to_index[row]
            new_pos = interval_ptr[lam_j]

            swap_node = index_to_node[new_pos]
            index_to_node[old_pos] = swap_node
            index_to_node[new_pos] = row
            node_to_index[row] = new_pos
            node_to_index[swap_node] = old_pos

            lam[row] -= 1
            interval_count[lam_j] -= 1
            interval_count[lam_j - 1] += 1
            interval_ptr[lam_j] += 1

    return splitting
