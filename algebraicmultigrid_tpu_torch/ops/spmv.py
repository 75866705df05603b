"""Device SpMV over the padded ELL format.

The reference's solve phase runs three CSC SpMVs per level per cycle
(residual, restrict, prolong — AlgebraicMultigrid.jl
``src/multilevel.jl:218-234``) as scalar loops.  Here each ELL SpMV is one
gather, multiply and row sum over the padded layout.  The JAX package runs
it as an XLA gather, not as a Pallas kernel, so plain torch is its port.
"""

from __future__ import annotations

import torch

from .sparse import ELL

__all__ = ["ell_spmv"]


def ell_spmv(A: ELL, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` for x of length >= ``A.shape[1]`` (level vectors stay
    padded), flat or a multi-RHS block ``x[n, k]``; returns y of length
    ``A.rows_padded`` (by k).  Padding slots read x[0] and multiply it by a
    stored 0."""
    data = A.data if x.dim() == 1 else A.data.unsqueeze(-1)
    return (data * x[A.cols]).sum(dim=1)
