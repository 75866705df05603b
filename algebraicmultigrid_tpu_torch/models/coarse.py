"""Coarse-level dense solvers.

Parity with AlgebraicMultigrid.jl ``src/coarse_solver.jl``: a coarse solver is
constructed from the final-level matrix and called as ``cs(x, b)``
(coarse_solver.jl:2).  The coarse grid is tiny (≤ max_coarse, default 10) and
dense-factorised once at setup; on device the apply is a replicated dense
triangular-solve / matmul — the TPU-native equivalent of the reference's
replicated direct solve (survey §7).

* :class:`Pinv` — Moore-Penrose pseudo-inverse; handles **singular** coarse
  operators (semidefinite graph Laplacians, no-NNS elasticity;
  coarse_solver.jl:9-16).
* :class:`QRSolver` — QR factorisation with per-RHS backsubstitution
  (coarse_solver.jl:66-81); the default (coarse_solver.jl:84).  If R is
  numerically rank-deficient we fall back to the pseudo-inverse apply, which
  matches Julia's rank-revealing sparse QR behaviour on singular inputs.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.sparse as sp

__all__ = [
    "CoarseSolver",
    "Pinv",
    "QRSolver",
    "LinearSolveWrapper",
    "SpluSolver",
    "default_coarse_solver",
]


def _dense(A) -> np.ndarray:
    return A.toarray() if sp.issparse(A) else np.asarray(A)


class CoarseSolver:
    """Callable protocol: ``cs(x, b)`` fills x in place; ``cs.apply(b)``
    returns the solution functionally (device-friendly form)."""

    def __call__(self, x, b):
        x[...] = self.apply(b)
        return x

    def apply(self, b):
        raise NotImplementedError


class Pinv(CoarseSolver):
    def __init__(self, A):
        self.pinvA = np.linalg.pinv(_dense(A))

    def apply(self, b):
        return self.pinvA @ b

    def __repr__(self):
        return "Pinv"


class QRSolver(CoarseSolver):
    # Above this size a dense O(n³) QR is pathological; the reference's
    # ``qr(A::SparseMatrixCSC)`` is SuiteSparse's SPARSE QR, so a large
    # coarse grid (degenerate hierarchies, e.g. all-isolated strength
    # graphs, test_regression.jl #56) is cheap there.  scipy has no sparse
    # QR — use sparse LU for large sparse inputs, falling back to the dense
    # rank-revealing path only if the LU reports singularity.
    _sparse_threshold = 512

    def __init__(self, A):
        if sp.issparse(A) and A.shape[0] > self._sparse_threshold:
            import scipy.sparse.linalg as spla

            try:
                self._splu = spla.splu(sp.csc_matrix(A))
                self.Q = self.R = self.pinvA = None
                self._singular = False
                return
            except RuntimeError:
                pass  # singular → dense rank-revealing fallback below
        self._splu = None
        M = _dense(A)
        self.Q, self.R = np.linalg.qr(M)
        rdiag = np.abs(np.diag(self.R)) if self.R.size else np.zeros(0)
        scale = rdiag.max() if rdiag.size else 0.0
        n = M.shape[0]
        self._singular = (
            M.shape[0] != M.shape[1]
            or rdiag.size == 0
            or (rdiag < max(M.shape) * np.finfo(M.dtype if M.dtype.kind in "fc" else np.float64).eps * max(scale, 1e-300)).any()
        )
        self.pinvA = np.linalg.pinv(M) if self._singular else None

    def apply(self, b):
        if self._splu is not None:
            b = np.asarray(b)
            if b.ndim == 1:
                return self._splu.solve(b)
            return np.stack(
                [np.asarray(self._splu.solve(b[:, j])) for j in range(b.shape[1])],
                axis=1,
            )
        if self._singular:
            return self.pinvA @ b
        y = self.Q.conj().T @ b
        return scipy.linalg.solve_triangular(self.R, y, lower=False)

    def __repr__(self):
        return "QRSolver"


class LinearSolveWrapper:
    """Adapter wrapping an arbitrary external solve algorithm as a coarse
    solver (parity with ``coarse_solver.jl:24-58``, where any LinearSolve.jl
    algorithm is wrapped via an init/solve! cache with a per-RHS-column loop).

    ``alg`` is a factorisation factory ``alg(A) -> obj`` where ``obj`` either
    exposes ``.solve(b)`` (e.g. ``scipy.sparse.linalg.splu`` — the UMFPACK
    analogue used in the reference tests, test/runtests.jl:126) or is itself a
    callable ``b -> x``.  The config object is passed as
    ``coarse_solver=LinearSolveWrapper(alg)`` and, like the reference's
    outer/internal pair, calling it with the final-level matrix builds the
    cached internal solver.
    """

    def __init__(self, alg):
        self.alg = alg

    def __call__(self, A):
        return _LinearSolveWrapperInternal(self.alg, A)

    def __repr__(self):
        return f"LinearSolveWrapper({self.alg!r})"


class _LinearSolveWrapperInternal(CoarseSolver):
    def __init__(self, alg, A):
        self._cache = alg(sp.csc_matrix(A) if sp.issparse(A) else A)
        self._solve = (
            self._cache.solve if hasattr(self._cache, "solve") else self._cache
        )

    def apply(self, b):
        b = np.asarray(b)
        if b.ndim == 1:
            return self._solve(b)
        # per-RHS-column loop (coarse_solver.jl:47-53)
        cols = [np.asarray(self._solve(b[:, j])) for j in range(b.shape[1])]
        return np.stack(cols, axis=1)

    def __repr__(self):
        return "LinearSolveWrapper"


def SpluSolver(A):
    """Sparse-LU coarse solver (the reference's UMFPACKFactorization analogue,
    test/runtests.jl:126): usable directly as ``coarse_solver=SpluSolver``."""
    import scipy.sparse.linalg as spla

    return _LinearSolveWrapperInternal(
        lambda M: spla.splu(sp.csc_matrix(M)), A
    )


def default_coarse_solver(A):
    """Pick the default coarse-solver factory (coarse_solver.jl:84)."""
    return QRSolver
