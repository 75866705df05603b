"""Parallel (data-parallel-shaped) setup kernels: PMIS splitting and
label-propagation aggregation.

The reference's RS splitting (splitting.jl:25-159) and standard aggregation
(aggregate.jl:19-113) are greedy-sequential bucket/queue algorithms — the
hardest-to-parallelize pieces of the setup (SURVEY §2.4, §7 hard-part 1).
This module supplies their scalable counterparts, built entirely from
rounds of O(nnz) vectorised neighbourhood reductions (per-row max /
argmax) — the shape that maps onto segmented device reductions and, across
row-sharded levels, onto one halo exchange per round:

* :class:`PMIS` — the distance-1 parallel-modified-independent-set C/F
  splitting of De Sterck/Yang/Heys (SIAM J. Sci. Comp. 27(4), 2006).
  Deterministic: the tie-breaker is a fixed golden-ratio hash, so results
  are reproducible and shard-count-independent.
* :class:`LabelPropAggregation` — aggregation as a distance-2 MIS of seeds
  plus strongest-edge label propagation; mirrors the aggregate semantics
  (every non-isolated node in exactly one aggregate, isolated nodes in
  none — zero columns, aggregate.jl:115-133).

Both are *opt-in* (``ruge_stuben(A, CF=PMIS())``,
``smoothed_aggregation(A, aggregate=LabelPropAggregation())``) and are
validated by hierarchy-quality metrics (operator complexity, PCG iteration
counts) rather than exact-output pins — matching the survey's guidance that
exact greedy order is not the contract (§2.4, §7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..ops.sparse import as_csr
from .splitting import C_NODE, F_NODE, _remove_diag

__all__ = ["PMIS", "LabelPropAggregation"]

_PHI = 0.6180339887498949  # golden-ratio hash for deterministic tie-breaks


def _tiebreak(n: int) -> np.ndarray:
    """Deterministic pseudo-random weights in (0, 1), pairwise distinct for
    n < ~1e15 (Weyl sequence) — reproducible across runs and shardings."""
    return ((np.arange(1, n + 1, dtype=np.float64) * _PHI) % 1.0) * 0.999 + 5e-4


def _row_reduce_max(indptr, data):
    """Per-row max of a CSR's data (empty rows → -inf)."""
    n = indptr.shape[0] - 1
    out = np.full(n, -np.inf)
    counts = np.diff(indptr)
    nz = counts > 0
    if data.size:
        red = np.maximum.reduceat(data, indptr[:-1][nz])
        out[nz] = red
    return out


@dataclasses.dataclass(frozen=True)
class PMIS:
    """Parallel modified independent set C/F splitting (opt-in CF rule).

    Callable on a strength matrix like :class:`~.splitting.RS`; returns the
    0/1 F/C array.  Weights are the RS measure λ (number of points i
    strongly influences, splitting.jl:41-63) plus a deterministic (0,1)
    tie-break; rounds select local weight maxima over the symmetrised
    strong graph as C and their undecided neighbours as F."""

    max_rounds: int = 200

    def __call__(self, S) -> np.ndarray:
        S = as_csr(_remove_diag(sp.csc_matrix(as_csr(S))))
        n = S.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        # λ: count of nodes strongly influenced by i = column counts of S
        # (S[i, j] = strength of j's influence on i, strength.jl:36 layout —
        # matches RS_CF_splitting's λ from T = Sᵀ)
        lam = np.asarray((S != 0).sum(axis=0)).ravel().astype(np.float64)
        w = lam + _tiebreak(n)

        G = ((S != 0) + (S != 0).T).tocsr()  # symmetrised strong graph
        G.sort_indices()
        indptr, indices = G.indptr, G.indices

        state = np.full(n, 2, dtype=np.int64)  # 2 = undecided (U_NODE)
        isolated = np.diff(indptr) == 0
        state[isolated] = F_NODE  # λ=0 nodes become F (splitting.jl:67-71)

        for _ in range(self.max_rounds):
            undecided = state == 2
            if not undecided.any():
                break
            wu = np.where(undecided, w, -np.inf)
            nbmax = _row_reduce_max(indptr, wu[indices])
            new_C = undecided & (np.where(undecided, w, -np.inf) > nbmax)
            state[new_C] = C_NODE
            # undecided strong neighbours of new C points become F
            touch = np.zeros(n, dtype=bool)
            touched_cols = indices[np.repeat(new_C, np.diff(indptr))]
            touch[touched_cols] = True
            state[(state == 2) & touch] = F_NODE
        else:
            raise RuntimeError("PMIS did not converge")
        return np.where(state == C_NODE, C_NODE, F_NODE).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class LabelPropAggregation:
    """Aggregation by seed-MIS + strongest-edge label propagation
    (opt-in ``aggregate=`` rule for :func:`~.aggregation.smoothed_aggregation`).

    1. seeds = PMIS-style independent set of the strong graph's SQUARE
       (distance-2 MIS → aggregate roots spaced like the greedy pass-1
       seeds of aggregate.jl:19-51);
    2. every node joins the strongest-coupled neighbouring aggregate
       (``rounds`` sweeps of label propagation, aggregate.jl:54-74 analogue);
    3. leftovers with no aggregated neighbour seed their own aggregate;
       isolated nodes stay unaggregated (zero columns in AggOp).

    Returns the (n_agg × n_fine) 0/1 CSR AggOp of aggregate.jl:115-133.
    """

    rounds: int = 3
    max_mis_rounds: int = 200

    def __call__(self, S) -> sp.csr_matrix:
        S = as_csr(_remove_diag(sp.csc_matrix(as_csr(S))))
        n = S.shape[0]
        if n == 0:
            return sp.csr_matrix((0, 0))
        Gs = ((S != 0) + (S != 0).T).tocsr()
        isolated = np.diff(Gs.indptr) == 0

        # --- 1. distance-2 seed MIS over the non-isolated nodes
        w = np.asarray(Gs.sum(axis=1)).ravel().astype(np.float64) + _tiebreak(n)
        G2 = (Gs @ Gs + Gs).tocsr()  # distance ≤ 2 neighbourhood
        G2.sort_indices()
        indptr2, indices2 = G2.indptr, G2.indices
        state = np.full(n, 2, dtype=np.int64)
        state[isolated] = 0  # never seeds, never aggregated
        for _ in range(self.max_mis_rounds):
            undecided = state == 2
            if not undecided.any():
                break
            wu = np.where(undecided, w, -np.inf)
            nbmax = _row_reduce_max(indptr2, wu[indices2])
            # exclude self-coupling in G2 (diagonal) from the comparison by
            # strict inequality on distinct tie-break weights
            new_seed = undecided & (wu >= nbmax) & np.isfinite(wu)
            state[new_seed] = 1
            touch = np.zeros(n, dtype=bool)
            touch[indices2[np.repeat(new_seed, np.diff(indptr2))]] = True
            state[(state == 2) & touch & ~new_seed] = -1  # covered
        else:
            raise RuntimeError("seed MIS did not converge")

        seeds = np.flatnonzero(state == 1)
        label = np.full(n, -1, dtype=np.int64)
        label[seeds] = np.arange(seeds.shape[0])

        # --- 2. strongest-edge label propagation on |S| + |S|ᵀ
        W = abs(S) + abs(S).T
        W = W.tocsr()
        W.sort_indices()
        iptr, idx, vals = W.indptr, W.indices, W.data
        rows = np.repeat(np.arange(n), np.diff(iptr))
        for _ in range(max(1, self.rounds)):
            un = label < 0
            if not un.any():
                break
            has_lab = label[idx] >= 0
            cand = un[rows] & has_lab & ~isolated[rows]
            if not cand.any():
                break
            # per row: the strongest labelled-neighbour edge.  Sorting by
            # (row, weight) groups rows contiguously with ascending weight,
            # so each row's max sits at its CSR end offset.
            key = np.where(cand, vals, -np.inf)
            order = np.lexsort((key, rows))
            ks = key[order]
            labs = label[idx][order]
            cnts = np.diff(iptr)
            nzrows = cnts > 0
            ends = iptr[1:][nzrows] - 1
            best_val = np.full(n, -np.inf)
            best_lab = np.full(n, -1, dtype=np.int64)
            best_val[nzrows] = ks[ends]
            best_lab[nzrows] = labs[ends]
            adopt = un & np.isfinite(best_val) & (best_lab >= 0)
            label[adopt] = best_lab[adopt]

        # --- 3. leftovers seed their own aggregates
        left = np.flatnonzero((label < 0) & ~isolated)
        if left.size:
            extra = np.arange(left.shape[0]) + (int(label.max()) + 1 if label.max() >= 0 else 0)
            label[left] = extra

        n_agg = int(label.max()) + 1 if (label >= 0).any() else 0
        keep = label >= 0
        return sp.csr_matrix(
            (
                np.ones(int(keep.sum()), dtype=np.float64),
                (label[keep], np.flatnonzero(keep)),
            ),
            shape=(n_agg, n),
        )
