"""Ruge-Stüben (classical) AMG hierarchy setup driver.

Parity with AlgebraicMultigrid.jl ``src/classical.jl:6-55``: per level —
strength → RS splitting → direct interpolation → Galerkin ``RAP = R·A·P`` —
until ``max_levels``/``max_coarse`` or an empty prolongator stops coarsening.
The near-null-space kwarg ``B`` is rejected (classical.jl:17-18).

The Galerkin triple product runs as scipy CSR SpGEMM (C-speed two-pass, the
same count/fill structure the reference gets from Julia's stdlib SpGEMM).
A lattice operator with ``CF=StructuredRS()`` and classical strength takes
the structured fast path (``fastsetup.structured_ruge_stuben``, the same
hierarchy at O(boundary) cost); any other lattice operator is assembled and
runs the generic path.
"""

from __future__ import annotations

from ..config import GaussSeidel
from ..ops.sparse import as_csc, as_csr
from ..utils.symmetry import HermitianSymmetry
from .coarse import default_coarse_solver
from .interpolation import direct_interpolation
from .multilevel import Level, MultiLevel
from .splitting import RS
from .strength import Classical

__all__ = ["ruge_stuben"]


def ruge_stuben(
    A,
    *,
    strength=Classical(0.25),
    symmetry=HermitianSymmetry(),
    CF=RS(),
    presmoother=GaussSeidel(),
    postsmoother=GaussSeidel(),
    max_levels: int = 10,
    max_coarse: int = 10,
    coarse_solver=None,
    B=None,
    blocksize: int = 1,
    **kwargs,
) -> MultiLevel:
    """Build a classical AMG hierarchy for ``A`` (classical.jl:6-34)."""
    if B is not None:
        raise ValueError(
            "near null space `B` is only supported for smoothed aggregation "
            "AMG, not Ruge-Stüben AMG."
        )  # classical.jl:17-18
    from .lattice import LatticeMatrix
    from .structured import StructuredRS

    if isinstance(A, LatticeMatrix):
        if isinstance(CF, StructuredRS) and isinstance(strength, Classical):
            from .fastsetup import structured_ruge_stuben

            return structured_ruge_stuben(
                A,
                CF=CF,
                strength=strength,
                symmetry=symmetry,
                presmoother=presmoother,
                postsmoother=postsmoother,
                max_levels=max_levels,
                max_coarse=max_coarse,
                coarse_solver=coarse_solver,
                **kwargs,
            )
        A = A.tocsr()  # non-structured policies: assemble + generic path
    A = as_csc(A)
    if coarse_solver is None:
        coarse_solver = default_coarse_solver(A)

    levels = []
    while len(levels) + 1 < max_levels and A.shape[0] > max_coarse:
        A, stop = _extend_hierarchy_rs(
            levels, strength, CF, A, presmoother, postsmoother, symmetry
        )
        if stop:
            break

    cs = coarse_solver(A)
    return MultiLevel(levels, as_csr(A), cs, symmetry=symmetry)


def _extend_hierarchy_rs(levels, strength, CF, A, presmoother, postsmoother, symmetry):
    """One coarsening step (classical.jl:36-55)."""
    if isinstance(symmetry, HermitianSymmetry):
        At = A
    else:
        At = as_csc(A.T)  # materialised adjoint (utils.jl:21-23)
    S, T = strength(At)
    splitting = CF(S)
    P, R = direct_interpolation(At, T, splitting)
    if P.shape[1] == 0:
        return A, True
    RAP = as_csc((R @ (A @ P)).tocsc())

    A_csr = as_csr(A)
    levels.append(
        Level(
            A=A_csr,
            P=as_csr(P),
            R=as_csr(R),
            presmoother_config=presmoother,
            postsmoother_config=postsmoother,
            symmetry=symmetry,
        )
    )
    return RAP, False
