"""Graph coloring for multicolor (TPU-parallel) relaxation.

The reference's Gauss-Seidel/SOR fast paths are sequential recurrences
(AlgebraicMultigrid.jl ``src/smoother.jl:73-90,205-221``) — unusable on a vector
machine.  Multicolor relaxation partitions rows into independent sets; rows
within a color have no mutual coupling, so updating a whole color at once IS
Gauss-Seidel for the color-permuted ordering.  Each color step becomes a
dense-regular batched row update on the TPU VPU.

Implemented as a vectorised Jones–Plassmann greedy: numpy-only, O(E) work
per round, deterministic (seeded priorities), no Python per-node loop — so
it scales to multi-million-row setup on the host.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .sparse import as_csr

__all__ = ["graph_coloring", "jp_coloring", "color_steps", "steps2_list"]


def color_steps(n_colors, iters, fwd, bwd, omega=1.0):
    """The sequence of color updates for a (possibly symmetric) multicolor
    GS/SOR sweep, with adjacent duplicates collapsed when ω == 1.

    A symmetric sweep is forward ``[0..n)`` then backward ``[n)..0]`` — the
    boundary repeats the last color.  At ω == 1 a color update is the exact
    row solve given fixed neighbours, i.e. a projection: repeating it is the
    identity (the color's residual is already zero), so the duplicate step
    is dropped.  At ω ≠ 1 the blended update is not idempotent and the full
    sequence is kept.  Every multicolor engine (masked XLA, fused Pallas)
    derives its steps from here so cross-path bitwise tests stay exact."""
    steps = []
    for _ in range(iters):
        if fwd:
            steps += list(range(n_colors))
        if bwd:
            steps += list(range(n_colors - 1, -1, -1))
    if omega == 1.0:
        out = []
        for c in steps:
            if not out or out[-1] != c:
                out.append(c)
        steps = out
    return tuple(steps)


def steps2_list(n_colors, iters, fwd, bwd, omega=1.0):
    """Steps of the cross-cycle double sweep (postsmooth of one cycle
    directly followed by presmooth of the next, same config): two sweeps
    back to back, with the boundary duplicate collapsed at ω == 1 by the
    same idempotence argument as within a symmetric sweep."""
    s = color_steps(n_colors, iters, fwd, bwd, omega)
    if omega == 1.0 and s and s[0] == s[-1]:
        return s + s[1:]
    return s + s


def graph_coloring(A, seed: int = 0) -> np.ndarray:
    """Default coloring: the vectorised Jones-Plassmann numpy tier.  (The JAX
    package prefers its native natural-order greedy kernel, so the two may
    color a general graph differently; lattice levels use the periodic
    ``lattice_coloring`` in both packages.)"""
    return jp_coloring(A, seed=seed)


def jp_coloring(A, seed: int = 0, max_rounds: int = 10_000) -> np.ndarray:
    """Color the adjacency graph of ``A`` (symmetrised, diagonal ignored).

    Returns ``colors[n]`` with colors 0..k-1 such that no stored off-diagonal
    entry (i, j) of A+Aᵀ has colors[i] == colors[j].
    """
    M = as_csr(A)
    n = M.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    G = (M + M.T).tocsr()
    rows = np.repeat(np.arange(n), np.diff(G.indptr))
    cols = G.indices
    off = rows != cols
    ei, ej = rows[off], cols[off]

    rng = np.random.default_rng(seed)
    prio = rng.permutation(n)

    colors = np.full(n, -1, dtype=np.int32)
    undecided = np.ones(n, dtype=bool)
    n_colors = 0

    for _ in range(max_rounds):
        if not undecided.any():
            break
        # Max priority among undecided neighbours of each undecided node.
        live = undecided[ei] & undecided[ej]
        nbr_max = np.full(n, -1, dtype=np.int64)
        np.maximum.at(nbr_max, ei[live], prio[ej[live]])
        winners = undecided & (prio > nbr_max)
        if not winners.any():  # isolated-in-round nodes: all remaining win
            winners = undecided
        # Greedy smallest-available color per winner.
        assigned = np.zeros(n, dtype=bool)
        for c in range(n_colors + 1):
            cand = winners & ~assigned
            if not cand.any():
                break
            conflict = np.zeros(n, dtype=bool)
            nbr_is_c = colors[ej] == c
            np.logical_or.at(conflict, ei[nbr_is_c], True)
            take = cand & ~conflict
            colors[take] = c
            assigned |= take
            n_colors = max(n_colors, c + 1)
        # Anything still unassigned among winners opens a fresh color.
        rest = winners & ~assigned
        if rest.any():
            colors[rest] = n_colors
            n_colors += 1
        undecided &= colors < 0
    if undecided.any():
        raise RuntimeError("jp_coloring did not converge")
    return colors
