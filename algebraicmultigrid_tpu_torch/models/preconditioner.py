"""Preconditioner adapter — one fixed linear AMG cycle per application.

Parity with AlgebraicMultigrid.jl ``src/preconditioner.jl``: ``aspreconditioner(ml,
cycle=V())`` wraps the hierarchy so that each application runs **exactly one
cycle from a zero initial guess** with no residual test
(preconditioner.jl:12-19) — the linear, fixed operator contract CG requires
(survey §3.4).  ``mul`` applies the fine operator (preconditioner.jl:20).

A copy of the JAX package's module, exposed both as numpy callables (for
the host engine / scipy's CG) and as a device apply on the torch engine
(``device_apply_fn``, the port's ``device_cycle_fn``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..config import Cycle, V
from .multilevel import MultiLevel, solve_mg

__all__ = ["Preconditioner", "aspreconditioner"]


@dataclasses.dataclass
class Preconditioner:
    ml: MultiLevel
    init: str = "zero"
    cycle: Cycle = V()

    def apply(self, b: np.ndarray) -> np.ndarray:
        """x = M⁻¹ b : one cycle (preconditioner.jl:12-19)."""
        x = None if self.init == "zero" else np.array(b, copy=True)
        return solve_mg(
            self.ml, b, self.cycle, x=x, maxiter=1, calculate_residual=False
        )

    # scipy.sparse.linalg.LinearOperator-style interface
    def matvec(self, b):
        return self.apply(b)

    def __matmul__(self, b):
        return self.apply(b)

    def mul(self, x):
        """Apply the *fine operator* A₁ (preconditioner.jl:20)."""
        A = self.ml.levels[0].A if self.ml.levels else self.ml.final_A
        return A @ x

    @property
    def shape(self):
        A = self.ml.levels[0].A if self.ml.levels else self.ml.final_A
        return A.shape

    @property
    def dtype(self):
        A = self.ml.levels[0].A if self.ml.levels else self.ml.final_A
        return A.dtype

    def device_apply_fn(self, dtype=None, device=None, **kwargs):
        """Return ``b -> M⁻¹b`` on the device hierarchy (``device_cycle_fn``:
        one cycle from zero; the card unless ``device`` says otherwise;
        ``coef_dtype`` and ``subcycle`` pass through)."""
        from .device import device_cycle_fn

        return device_cycle_fn(self.ml, self.cycle, device=device, dtype=dtype, **kwargs)


def aspreconditioner(ml: MultiLevel, cycle: Cycle = V()) -> Preconditioner:
    return Preconditioner(ml, "zero", cycle)
