"""Graph coloring for multicolor (TPU-parallel) relaxation.

The reference's Gauss-Seidel/SOR fast paths are sequential recurrences
(AlgebraicMultigrid.jl ``src/smoother.jl:73-90,205-221``) — unusable on a vector
machine.  Multicolor relaxation partitions rows into independent sets; rows
within a color have no mutual coupling, so updating a whole color at once IS
Gauss-Seidel for the color-permuted ordering.  Each color step becomes a
dense-regular batched row update on the TPU VPU.

The coloring is the native natural-order greedy kernel
(``native/amg_setup.cpp``), as in the JAX package, so both packages color a
general graph alike.
"""

from __future__ import annotations

import numpy as np

from .sparse import as_csr

__all__ = [
    "graph_coloring", "color_steps", "steps2_list",
]


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


def graph_coloring(A, assume_symmetric: bool = False) -> np.ndarray:
    """Natural-order greedy coloring of the adjacency graph of ``A``
    (symmetrised unless ``assume_symmetric``, diagonal ignored) by the
    native kernel: colors 0..k-1, no stored off-diagonal entry joins two
    rows of one color."""
    from ..native.build import as_i32_ptr, as_i64_ptr, get_native

    lib = get_native()
    M = as_csr(A)
    n = M.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    G = M if assume_symmetric else (M + M.T).tocsr()
    Gp = np.ascontiguousarray(G.indptr, dtype=np.int64)
    Gj = np.ascontiguousarray(G.indices, dtype=np.int64)
    colors = np.zeros(n, dtype=np.int32)
    lib.greedy_coloring(n, as_i64_ptr(Gp), as_i64_ptr(Gj), as_i32_ptr(colors))
    return colors
