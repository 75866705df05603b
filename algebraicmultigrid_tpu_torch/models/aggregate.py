"""Standard (greedy) aggregation — Vaněk/Mandel/Brezina Alg. 5.1.

Behavioural parity with AlgebraicMultigrid.jl ``src/aggregate.jl``:

* Pass 1: an unaggregated node with no aggregated neighbour (and at least
  one neighbour) seeds a new aggregate containing itself and all neighbours;
  isolated nodes are marked and never aggregated (aggregate.jl:19-51).
* Pass 2: remaining nodes join the *strongest* neighbouring aggregate, with
  negative recording to avoid intra-pass cascading (aggregate.jl:54-74).
* Pass 3: leftovers seed new aggregates from the still-unaggregated
  neighbourhood (aggregate.jl:96-113).

Output ``AggOp``: (n_agg × n_fine) 0/1 sparse matrix; isolated nodes get
zero columns (aggregate.jl:115-133).  Contracts pinned by the reference
tests (test/sa_tests.jl:140-184) are re-pinned in ours.

Like RS splitting, this greedy sweep is order-dependent and sequential.
This package runs the Python loop below; the JAX package's C++ kernel has
identical semantics.  The structured fast path never reaches this sweep on
lattice levels (box aggregation), so its cost stays off the main path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from ..ops.sparse import as_csc

__all__ = ["StandardAggregation", "aggregate_ids"]


def _aggregate_ids_python(Sp, Sj, Sx, n):
    """Passes 1-3; returns (x, n_agg) with x = 0-based id or -1 (isolated)."""
    x = np.zeros(n, dtype=np.int64)
    next_aggregate = 1

    # Pass 1: tentative aggregation
    for i in range(n):
        if x[i] != 0:
            continue
        has_agg_neighbors = False
        has_neighbors = False
        for j in range(Sp[i], Sp[i + 1]):
            row = Sj[j]
            if row != i:
                has_neighbors = True
                if x[row] != 0:
                    has_agg_neighbors = True
                    break
        if not has_neighbors:
            x[i] = -n  # isolated marker
        elif not has_agg_neighbors:
            x[i] = next_aggregate
            for j in range(Sp[i], Sp[i + 1]):
                row = Sj[j]
                if row != i:
                    x[row] = next_aggregate
            next_aggregate += 1

    # Pass 2: enlarge tentative aggregates toward the strongest neighbour
    for i in range(n):
        if x[i] != 0:
            continue
        s_best = 0
        x_best = 0
        for j in range(Sp[i], Sp[i + 1]):
            row = Sj[j]
            x_row = x[row]
            s_candidate = Sx[j]
            if x_row > 0 and s_candidate > s_best:
                s_best = s_candidate
                x_best = x_row
        if x_best > 0:
            x[i] = -x_best

    unagg = x == 0

    # Shift to 0-based aggregate ids (aggregate.jl:82-94)
    next_aggregate -= 1
    pos = x > 0
    iso = x == -n
    neg = (x < 0) & ~iso
    x[pos] -= 1
    x[iso] = -1
    x[neg] = -x[neg] - 1

    # Pass 3: aggregate the leftovers
    for i in range(n):
        if not unagg[i]:
            continue
        x[i] = next_aggregate
        for j in range(Sp[i], Sp[i + 1]):
            row = Sj[j]
            if unagg[row]:
                x[row] = next_aggregate
                unagg[row] = False
        unagg[i] = False
        next_aggregate += 1

    return x, next_aggregate


def aggregate_ids(S: sp.csc_matrix):
    """Aggregate id per node (-1 = isolated) and aggregate count."""
    S = as_csc(S)
    n = S.shape[0]
    return _aggregate_ids_python(S.indptr, S.indices, S.data, n)


@dataclasses.dataclass(frozen=True)
class StandardAggregation:
    def __call__(self, S) -> sp.csr_matrix:
        S = as_csc(S)
        n = S.shape[0]
        x, N = aggregate_ids(S)

        vdtype = S.data.dtype if S.data.dtype.kind in "fc" else np.float64
        if n == 0 or (x.size and x.min() == -1):
            mask = x != -1
            cols = np.flatnonzero(mask)
            rows = x[mask]
            vals = np.ones(rows.size, dtype=vdtype)
            AggOp = sp.coo_matrix((vals, (rows, cols)), shape=(N, n)).tocsr()
        else:
            AggOp = sp.csr_matrix(
                (np.ones(n, dtype=vdtype), (x, np.arange(n))), shape=(N, n)
            )
        AggOp.sum_duplicates()
        AggOp.sort_indices()
        return AggOp
