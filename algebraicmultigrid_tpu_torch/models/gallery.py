"""Problem gallery — test/demo matrices.

Behavioural parity with AlgebraicMultigrid.jl ``src/gallery.jl``:

* ``poisson(n)``            — 1-D tridiagonal ``[-1, 2, -1]`` (gallery.jl:1-3)
* ``poisson((nx, ny, ...))``— N-D ±1-per-axis stencil, centre ``2N``
  (gallery.jl:42-61)
* ``stencil_grid(stencil, sz)`` — general N-D stencil assembly with boundary
  clipping (gallery.jl:5-38)

Implemented as vectorised numpy COO assembly (no scalar loops).  Index order
follows Julia's column-major ``LinearIndices`` so that hierarchies built on
these matrices match the reference's pinned level sizes exactly.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import scipy.sparse as sp

__all__ = ["poisson", "stencil_grid"]


def stencil_grid(stencil: np.ndarray, sz: Sequence[int], dtype=np.float64) -> sp.csr_matrix:
    """Assemble the sparse operator for ``stencil`` applied on an N-D grid.

    Grid points are numbered in Julia/Fortran (column-major) linear order to
    reproduce the reference's orderings (gallery.jl:14 ``LinearIndices``).
    Stencil offsets reaching outside the grid are clipped (Dirichlet-like).
    """
    stencil = np.asarray(stencil, dtype=dtype)
    sz = tuple(int(s) for s in sz)
    N = len(sz)
    if stencil.ndim != N:
        raise ValueError("stencil rank must match grid rank")

    n = int(np.prod(sz))
    # All grid multi-indices, column-major (first axis fastest) like Julia.
    grid_idx = np.unravel_index(np.arange(n), sz, order="F")  # tuple of [n]

    rows_acc, cols_acc, vals_acc = [], [], []
    offset = tuple((s + 1) // 2 - 1 for s in stencil.shape)  # 0-based centre

    for k in np.ndindex(*stencil.shape):
        v = stencil[k]
        if v == 0:
            continue
        shift = tuple(k[d] - offset[d] for d in range(N))
        tgt = [grid_idx[d] + shift[d] for d in range(N)]
        ok = np.ones(n, dtype=bool)
        for d in range(N):
            ok &= (tgt[d] >= 0) & (tgt[d] < sz[d])
        rows = np.flatnonzero(ok)
        cols = np.ravel_multi_index([t[ok] for t in tgt], sz, order="F")
        rows_acc.append(rows)
        cols_acc.append(cols)
        vals_acc.append(np.full(rows.size, v, dtype=dtype))

    A = sp.coo_matrix(
        (np.concatenate(vals_acc), (np.concatenate(rows_acc), np.concatenate(cols_acc))),
        shape=(n, n),
    ).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return A


def poisson(
    n: Union[int, Tuple[int, ...]], dtype=np.float64, lattice: bool = False
):
    """Discrete Poisson operator — 1-D tridiagonal or N-D stencil grid.

    With ``lattice=True`` returns a symbolic :class:`~.lattice.LatticeProblem`
    (1-D/2-D) or :class:`~.lattice_nd.LatticeProblemND` (N ≥ 3) instead of
    assembled scipy — the entry
    to the O(boundary) structured setup, usable at sizes where scipy assembly
    itself is prohibitive."""
    if isinstance(n, (tuple, list)):
        sz = tuple(int(s) for s in n)
        N = len(sz)
        stencil = np.zeros((3,) * N, dtype=dtype)
        centre = (1,) * N
        for d in range(N):
            for off in (-1, 1):
                idx = list(centre)
                idx[d] += off
                stencil[tuple(idx)] = -1
        stencil[centre] = 2 * N
        if lattice:
            if N <= 2:
                from .lattice import LatticeProblem

                return LatticeProblem(stencil, sz, dtype=dtype)
            from .lattice_nd import LatticeProblemND

            return LatticeProblemND(stencil, sz, dtype=dtype)
        return stencil_grid(stencil, sz, dtype=dtype)
    if lattice:
        from .lattice import LatticeProblem

        return LatticeProblem(
            np.array([-1, 2, -1], dtype=dtype), (int(n),), dtype=dtype
        )
    n = int(n)
    main = np.full(n, 2, dtype=dtype)
    off = np.full(n - 1, -1, dtype=dtype)
    return sp.diags([off, main, off], [-1, 0, 1], format="csr", dtype=dtype)
