"""Approximate spectral radius via restarted Arnoldi.

Parity with AlgebraicMultigrid.jl ``src/utils.jl:25-120``: modified-Gram-Schmidt
Arnoldi builds the Hessenberg H; the dominant eigenvalue of
H[1:maxiter, 1:maxiter] estimates ρ(A); the restart residual estimate is
``H[nvecs, nvecs-1] * evect[end, max_index]`` and the start vector is updated
to the dominant Ritz vector between restarts.  Breakdown thresholds per
float type follow utils.jl:119-120.

The reference seeds with ``rand`` (nondeterministic); we default to a seeded
generator for reproducibility (pass ``seed=None`` for fresh entropy).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["approximate_spectral_radius"]


def _breakdown(dtype) -> float:
    if np.dtype(dtype) == np.float32:
        return np.finfo(np.float64).eps * 10**3
    return np.finfo(np.float64).eps * 10**6


def approximate_spectral_radius(
    A, tol: float = 0.01, maxiter: int = 15, restart: int = 5, seed: int | None = 0
) -> float:
    n = A.shape[0]
    if n == 0:
        return 0.0
    dtype = A.dtype if hasattr(A, "dtype") else np.float64
    rng = np.random.default_rng(seed)
    v0 = rng.random(n).astype(dtype, copy=False)
    maxiter = min(n, maxiter)

    ev = np.zeros(maxiter, dtype=np.complex128)
    max_index = 0
    for _ in range(restart + 1):
        evect, ev, H, V, flag = _approximate_eigenvalues(A, maxiter, v0)
        nvecs = ev.shape[0]
        max_index = int(np.argmax(np.abs(ev)))
        err = H[nvecs - 1, nvecs - 2] * evect[-1, max_index]
        X = np.zeros((n, maxiter), dtype=dtype)  # utils.jl:70-75 copies V[1:end-1]
        for i, v in enumerate(V[:-1]):
            X[:, i] = v
        v0 = (X @ evect[:, max_index]).real.astype(dtype, copy=False)
        if abs(err) / abs(ev[max_index]) < tol or flag:
            break
    return float(abs(ev[max_index]))


def _approximate_eigenvalues(A, maxiter: int, v0: np.ndarray):
    v0 = v0 / np.linalg.norm(v0)
    dtype = v0.dtype
    H = np.zeros((maxiter + 1, maxiter), dtype=dtype)
    V = [v0]
    breakdown = _breakdown(dtype)
    flag = False

    for j in range(maxiter):
        w = A @ V[-1]
        for i, v in enumerate(V):
            H[i, j] = np.vdot(v, w)
            w = w - H[i, j] * v
        H[j + 1, j] = np.linalg.norm(w)
        if H[j + 1, j] < breakdown:
            flag = True
            if H[j + 1, j] != 0:
                V.append(w / H[j + 1, j])
            break
        V.append(w / H[j + 1, j])

    eigs, vects = np.linalg.eig(H[:maxiter, :maxiter])
    return vects, eigs, H, V, flag
