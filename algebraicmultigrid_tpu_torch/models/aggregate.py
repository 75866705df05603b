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

Like RS splitting, this greedy sweep is order-dependent and sequential; it
runs in the C++ kernel of ``native/amg_setup.cpp`` (multi-million-row
setup), a copy of the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from ..ops.sparse import as_csc

__all__ = ["StandardAggregation", "aggregate_ids"]


def aggregate_ids(S: sp.csc_matrix):
    """Aggregate id per node (-1 = isolated) and aggregate count."""
    S = as_csc(S)
    n = S.shape[0]
    from ..native.build import as_f64_ptr, as_i64_ptr, get_native

    lib = get_native()
    if n == 0:
        return np.zeros(0, dtype=np.int64), 0
    Sp = np.ascontiguousarray(S.indptr, dtype=np.int64)
    Sj = np.ascontiguousarray(S.indices, dtype=np.int64)
    Sx = np.ascontiguousarray(S.data, dtype=np.float64)
    x = np.zeros(n, dtype=np.int64)
    n_agg = lib.standard_aggregation(
        n, as_i64_ptr(Sp), as_i64_ptr(Sj), as_f64_ptr(Sx), as_i64_ptr(x)
    )
    return x, int(n_agg)


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
