"""Conjugate-gradient solver (host tier) exercising the preconditioner
contract in-repo.

A copy of the JAX package's ``ops/krylov.py`` (numpy/scipy).  The
reference delegates CG to IterativeSolvers.jl / LinearSolve.jl
(test/runtests.jl:186,227-240); this package ships its own so the
``aspreconditioner`` contract (one fixed linear cycle per application) is
tested end to end without external packages.  The device-side PCG is
``cg_device`` (models/device.py).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp

__all__ = ["cg"]


def cg(
    A,
    b: np.ndarray,
    M=None,
    x0: Optional[np.ndarray] = None,
    tol: float = 1e-8,
    abstol: float = 0.0,
    maxiter: Optional[int] = None,
    log: bool = False,
):
    """Preconditioned conjugate gradients: solve ``A x = b``.

    ``M`` is a left preconditioner exposing ``apply(r) -> z`` (e.g.
    :class:`~algebraicmultigrid_tpu_torch.models.preconditioner.Preconditioner`)
    or any callable.  Convergence: ``‖r‖ ≤ max(tol·‖b‖, abstol)``.
    """
    b = np.asarray(b)
    n = b.shape[0]
    maxiter = maxiter if maxiter is not None else 10 * n

    def psolve(r):
        if M is None:
            return r
        if hasattr(M, "apply"):
            return M.apply(r)
        return M(r)

    x = np.zeros_like(b) if x0 is None else np.array(x0, copy=True)
    r = b - A @ x
    normb = np.linalg.norm(b)
    threshold = max(tol * normb, abstol)
    residuals = [np.linalg.norm(r)]

    z = psolve(r)
    p = z.copy()
    rz = np.vdot(r, z)
    for _ in range(maxiter):
        if residuals[-1] <= threshold:
            break
        Ap = A @ p
        alpha = rz / np.vdot(p, Ap)
        x += alpha * p
        r -= alpha * Ap
        residuals.append(np.linalg.norm(r))
        if residuals[-1] <= threshold:
            break
        z = psolve(r)
        rz_new = np.vdot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new

    return (x, residuals) if log else x
