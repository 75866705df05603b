"""Prolongator smoothing for smoothed aggregation.

Parity with AlgebraicMultigrid.jl ``src/aggregation.jl:1-59``:
``P = (I − ω·D̃⁻¹·A)^degree · T`` with two weighting strategies —

* :class:`LocalWeighting` (default): D̃ = row sums of |A|
  (aggregation.jl:26-47);
* :class:`DiagonalWeighting`: D̃ = diag(A) scaled by
  ω / ρ(D⁻¹A) via the restarted-Arnoldi spectral-radius estimate
  (aggregation.jl:19-24, utils.jl:25-55).

The SpGEMM runs as scipy CSR matmul on the host setup tier.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from ..ops.sparse import as_csr
from ..utils.arnoldi import approximate_spectral_radius

__all__ = ["JacobiProlongation", "LocalWeighting", "DiagonalWeighting"]


@dataclasses.dataclass(frozen=True)
class LocalWeighting:
    pass


@dataclasses.dataclass(frozen=True)
class DiagonalWeighting:
    pass


def _scale_rows(S: sp.csr_matrix, v: np.ndarray) -> sp.csr_matrix:
    out = S.copy()
    rows = np.repeat(np.arange(S.shape[0]), np.diff(S.indptr))
    out.data = out.data * v[rows]
    return out


def _weight(weighting, S: sp.csr_matrix, omega: float) -> sp.csr_matrix:
    if isinstance(weighting, DiagonalWeighting):
        d = S.diagonal()
        with np.errstate(divide="ignore"):
            d_inv = 1.0 / d
        D_inv_S = _scale_rows(S, d_inv)
        rho = approximate_spectral_radius(D_inv_S)
        return (omega / rho) * D_inv_S
    # LocalWeighting: D̃ = row sums of |A| (zero rows stay zero).
    D = np.asarray(np.abs(S).sum(axis=1)).ravel()
    D_inv = np.where(D != 0, 1.0 / np.where(D != 0, D, 1), 0.0)
    return omega * _scale_rows(S, D_inv)


@dataclasses.dataclass(frozen=True)
class JacobiProlongation:
    """ω-damped Jacobi prolongator smoother (aggregation.jl:1-17)."""

    omega: float = 4.0 / 3.0

    def __call__(self, A, T, S, B, degree: int = 1, weighting=LocalWeighting()):
        A = as_csr(A)
        D_inv_S = _weight(weighting, A, self.omega)
        P = as_csr(T)
        for _ in range(degree):
            P = (P - D_inv_S @ P).tocsr()
        P.sort_indices()
        return P
