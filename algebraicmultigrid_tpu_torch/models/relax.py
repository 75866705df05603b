"""Host (numpy/scipy) relaxation engine — the setup-time and conformance tier.

Smoother protocol, mirroring AlgebraicMultigrid.jl ``src/smoother.jl:1-9,25-49``:

    cache = setup_smoother_host(config, A_csr, symmetry)   # precompute
    cache.smooth(x, b)                                     # x ← x + M⁻¹(b−Ax), in place

Semantics parity:

* natural-order Gauss-Seidel / SOR reproduce the reference's sequential
  sweeps (smoother.jl:73-90,205-221) — implemented as C-speed sparse
  triangular solves instead of scalar loops:
      forward GS :  (D+L) x⁺ = b − U x
      forward SOR:  (D+ωL) x⁺ = ωb + ((1−ω)D − ωU) x
  Zero-diagonal rows are skipped (row frozen), matching ``gs!``'s
  ``ifelse(d == 0, x[i], …)`` — realised by rewriting those rows of the
  triangular factor to identity.  Under ``NoSymmetry`` the reference instead
  *throws* at setup (smoother.jl:226-246 DiagonalIndices); we do too.
* weighted Jacobi: x ← x + ωD⁻¹(b − Ax), zero-diag rows frozen
  (smoother.jl:101-171; both symmetry paths are algebraically identical).
* multicolor GS/SOR: the TPU-native ordering (see ops/coloring.py), also
  available on the host engine so both engines can be differentially tested.

All smoothers accept x, b of shape (n,) or (n, k) (multi-RHS, the
reference's ``bs`` blocking, smoother.jl:77,119,160,208).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import spsolve_triangular

from ..config import BackwardSweep, ForwardSweep, GaussSeidel, Jacobi, SOR, SymmetricSweep
from ..ops.coloring import graph_coloring
from ..ops.sparse import as_csr
from ..utils.symmetry import HermitianSymmetry, NoSymmetry

__all__ = ["setup_smoother_host", "HostSmoother"]


class HostSmoother:
    def smooth(self, x: np.ndarray, b: np.ndarray) -> np.ndarray:
        raise NotImplementedError


def _identity_fix_rows(M: sp.csr_matrix, rows: np.ndarray) -> sp.csr_matrix:
    """Replace the given rows of M with identity rows (zero-diag skip)."""
    if rows.size == 0:
        return M
    M = M.tolil()
    for r in rows:
        M.rows[r] = [int(r)]
        M.data[r] = [1.0]
    return M.tocsr()


@dataclasses.dataclass
class _TriangularSweeper(HostSmoother):
    """Shared natural-order GS/SOR machinery via triangular solves."""

    A: sp.csr_matrix
    omega: float
    iter: int
    forward: bool
    backward: bool

    def __post_init__(self):
        A = self.A
        d = A.diagonal()
        self._zrows = np.flatnonzero(d == 0)
        w = self.omega
        D = sp.diags(d)
        Ls, Us = sp.tril(A, -1, format="csr"), sp.triu(A, 1, format="csr")
        if self.forward:
            self._fwd_M = _identity_fix_rows((D + w * Ls).tocsr(), self._zrows)
            self._fwd_N = Us  # x⁺ = M⁻¹(ωb + ((1−ω)D − ωU)x)
            self._fwd_K = ((1 - w) * D).tocsr()
        if self.backward:
            self._bwd_M = _identity_fix_rows((D + w * Us).tocsr(), self._zrows)
            self._bwd_N = Ls
            self._bwd_K = ((1 - w) * D).tocsr()

    def _sweep(self, x, b, M, Nstrict, K, lower):
        w = self.omega
        rhs = w * b + K @ x - w * (Nstrict @ x)
        if self._zrows.size:
            rhs[self._zrows] = x[self._zrows]
        x[...] = spsolve_triangular(M, rhs, lower=lower)
        return x

    def smooth(self, x, b):
        for _ in range(self.iter):
            if self.forward:
                self._sweep(x, b, self._fwd_M, self._fwd_N, self._fwd_K, True)
            if self.backward:
                self._sweep(x, b, self._bwd_M, self._bwd_N, self._bwd_K, False)
        return x


@dataclasses.dataclass
class _JacobiSmoother(HostSmoother):
    A: sp.csr_matrix
    omega: float
    iter: int

    def __post_init__(self):
        d = self.A.diagonal()
        self._mask = d != 0
        self._dinv = np.where(self._mask, 1.0 / np.where(self._mask, d, 1), 0.0)

    def smooth(self, x, b):
        dinv = self._dinv if x.ndim == 1 else self._dinv[:, None]
        for _ in range(self.iter):
            x += self.omega * dinv * (b - self.A @ x)
        return x


@dataclasses.dataclass
class _MulticolorSweeper(HostSmoother):
    """Color-by-color GS/SOR; rows of one color update simultaneously."""

    A: sp.csr_matrix
    omega: float
    iter: int
    forward: bool
    backward: bool
    colors: Optional[np.ndarray] = None

    def __post_init__(self):
        A = self.A
        if self.colors is None:
            self.colors = graph_coloring(A)
        n_colors = int(self.colors.max()) + 1 if self.colors.size else 0
        d = A.diagonal()
        self._groups = []
        for c in range(n_colors):
            rows = np.flatnonzero(self.colors == c)
            dc = d[rows]
            mask = dc != 0
            dinv = np.where(mask, 1.0 / np.where(mask, dc, 1), 0.0)
            self._groups.append((rows, A[rows], dinv, mask))

    def _color_step(self, x, b, group):
        rows, Ac, dinv, mask = group
        w = self.omega
        r = b[rows] - Ac @ x
        if x.ndim == 1:
            upd = x[rows] + w * dinv * r
            x[rows] = np.where(mask, upd, x[rows])
        else:
            upd = x[rows] + w * dinv[:, None] * r
            x[rows] = np.where(mask[:, None], upd, x[rows])
        return x

    def smooth(self, x, b):
        for _ in range(self.iter):
            if self.forward:
                for g in self._groups:
                    self._color_step(x, b, g)
            if self.backward:
                for g in reversed(self._groups):
                    self._color_step(x, b, g)
        return x


def _sweep_flags(sweep):
    fwd = isinstance(sweep, (ForwardSweep, SymmetricSweep))
    bwd = isinstance(sweep, (BackwardSweep, SymmetricSweep))
    return fwd, bwd


def setup_smoother_host(config, A, symmetry=HermitianSymmetry()) -> HostSmoother:
    """Build a host smoother cache for ``A`` (smoother.jl:40-49 protocol)."""
    A = as_csr(A)
    if isinstance(config, Jacobi):
        return _JacobiSmoother(A, config.omega, config.iter)
    if isinstance(config, (GaussSeidel, SOR)):
        omega = config.omega if isinstance(config, SOR) else 1.0
        fwd, bwd = _sweep_flags(config.sweep)
        if config.ordering == "multicolor":
            return _MulticolorSweeper(A, omega, config.iter, fwd, bwd)
        if isinstance(symmetry, NoSymmetry) and (A.diagonal() == 0).any():
            # DiagonalIndices throws SingularException (smoother.jl:226-246).
            raise np.linalg.LinAlgError("singular diagonal in Gauss-Seidel/SOR setup")
        return _TriangularSweeper(A, omega, config.iter, fwd, bwd)
    raise TypeError(f"unknown smoother config: {config!r}")
