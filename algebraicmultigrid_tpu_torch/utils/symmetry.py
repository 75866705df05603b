"""Symmetry tags threaded through hierarchy setup.

Parity with AlgebraicMultigrid.jl ``src/utils.jl:1-19``: the tag picks smoother
fast paths and whether Aᵀ must be materialised during setup.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

__all__ = ["NoSymmetry", "HermitianSymmetry", "get_symmetry_and_data"]


@dataclasses.dataclass(frozen=True)
class NoSymmetry:
    pass


@dataclasses.dataclass(frozen=True)
class HermitianSymmetry:
    pass


def get_symmetry_and_data(A, check: bool = False):
    """Return ``(A, symmetry_tag)``.

    The reference unwraps ``Symmetric``/``Hermitian`` wrapper types
    (utils.jl:7-19); scipy has no such wrappers, so by default we follow the
    reference's implicit contract: the caller declares symmetry via the
    ``symmetry=`` kwarg.  With ``check=True`` we inspect the matrix instead.
    """
    if check:
        M = A.tocsr() if sp.issparse(A) else sp.csr_matrix(np.asarray(A))
        H = M.getH().tocsr()
        if (M - H).nnz == 0:
            return A, HermitianSymmetry()
        return A, NoSymmetry()
    return A, HermitianSymmetry()
