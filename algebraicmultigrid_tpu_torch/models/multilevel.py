"""Multilevel hierarchy and cycling engine.

Parity with AlgebraicMultigrid.jl ``src/multilevel.jl``:

* :class:`Level` / :class:`MultiLevel` containers (multilevel.jl:1-21),
* operator/grid complexity + pretty hierarchy report (multilevel.jl:63-114),
* V/W/F cycle recursion policy (multilevel.jl:200-212),
* the iteration loop with ``abstol = max(reltol·‖b‖, abstol)`` and per-cycle
  residual recomputation (multilevel.jl:158-198),
* one-cycle structure presmooth → residual → restrict → recurse/coarse-solve
  → prolong-correct → postsmooth (multilevel.jl:214-239).

Two engines run the same cycle structure:

* the **host engine** here (numpy/scipy, exact reference smoother semantics)
  — the conformance reference used for differential testing and small
  problems;
* the **device engine** (``models/device.py``) — PyTorch on the card (or
  on the CPU when asked), ``MultiLevel.solve(engine="torch")``, or
  ``cg_device`` / ``solve_refined``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional

import numpy as np
import scipy.sparse as sp

from ..config import Cycle, F, V, W
from .coarse import CoarseSolver

__all__ = ["Level", "MultiLevel", "solve_mg", "operator_complexity", "grid_complexity"]


class Level:
    """One hierarchy level: operator + transfer pair + smoothers.

    Host smoother caches are built lazily on first host-engine use — the
    device engine builds its own caches, so device-only flows never pay for
    the host triangular/multicolor setup.
    """

    def __init__(
        self,
        A: sp.csr_matrix,
        P: sp.csr_matrix,
        R: sp.csr_matrix,
        presmoother: Any = None,
        postsmoother: Any = None,
        presmoother_config: Any = None,
        postsmoother_config: Any = None,
        symmetry: Any = None,
    ):
        self.A = A
        self.P = P
        self.R = R
        self._pre_cache = presmoother
        self._post_cache = postsmoother
        self.presmoother_config = presmoother_config
        self.postsmoother_config = postsmoother_config
        self.symmetry = symmetry

    def _build(self, config):
        from ..utils.symmetry import HermitianSymmetry
        from .lattice import LatticeMatrix
        from .relax import setup_smoother_host

        sym = self.symmetry if self.symmetry is not None else HermitianSymmetry()
        A = self.A.tocsr() if isinstance(self.A, LatticeMatrix) else self.A
        return setup_smoother_host(config, A, sym)

    @property
    def presmoother(self):
        if self._pre_cache is None:
            self._pre_cache = self._build(self.presmoother_config)
        return self._pre_cache

    @property
    def postsmoother(self):
        if self._post_cache is None:
            self._post_cache = self._build(self.postsmoother_config)
        return self._post_cache

    def __repr__(self):
        return (
            f"Level with R {self.R.shape} | A {self.A.shape} | P {self.P.shape}"
        )


class MultiLevel:
    """AMG hierarchy: fine levels + final coarse operator + coarse solver."""

    def __init__(
        self,
        levels: List[Level],
        final_A: sp.csr_matrix,
        coarse_solver: CoarseSolver,
        symmetry=None,
        dtype=None,
    ):
        self.levels = levels
        self.final_A = final_A
        self.coarse_solver = coarse_solver
        self.symmetry = symmetry
        self.dtype = dtype if dtype is not None else final_A.dtype
        self._device_cache: dict = {}

    def __len__(self):
        return len(self.levels) + 1

    # --- diagnostics (multilevel.jl:98-114) ---------------------------------
    def operator_complexity(self) -> float:
        if self.levels:
            total = sum(l.A.nnz for l in self.levels) + self.final_A.nnz
            return total / self.levels[0].A.nnz
        return 1.0

    def grid_complexity(self) -> float:
        if self.levels:
            total = sum(l.A.shape[0] for l in self.levels) + self.final_A.shape[0]
            return total / self.levels[0].A.shape[0]
        return 1.0

    def __repr__(self):  # multilevel.jl:63-96
        total_nnz = self.final_A.nnz + sum(l.A.nnz for l in self.levels)
        lines = []
        for i, level in enumerate(self.levels):
            lines.append(
                "   %2d   %10d   %10d [%5.2f%%]"
                % (i + 1, level.A.shape[0], level.A.nnz, 100 * level.A.nnz / total_nnz)
            )
        lines.append(
            "   %2d   %10d   %10d [%5.2f%%]"
            % (
                len(self.levels) + 1,
                self.final_A.shape[0],
                self.final_A.nnz,
                100 * self.final_A.nnz / total_nnz,
            )
        )
        return (
            "Multilevel Solver\n"
            "-----------------\n"
            f"Operator Complexity: {round(self.operator_complexity(), 3)}\n"
            f"Grid Complexity: {round(self.grid_complexity(), 3)}\n"
            f"No. of Levels: {len(self)}\n"
            f"Coarse Solver: {self.coarse_solver!r}\n"
            "Level     Unknowns     NonZeros\n"
            "-----     --------     --------\n" + "\n".join(lines)
        )

    # --- solve façade -------------------------------------------------------
    def solve(self, b, cycle: Cycle = V(), *, engine: str = "numpy", **kwargs):
        """Run multigrid cycling to convergence (multilevel.jl:152-198)."""
        if engine == "numpy":
            return solve_mg(self, b, cycle, **kwargs)
        if engine == "torch":
            from .device import solve_device

            return solve_device(self, b, cycle, **kwargs)
        raise ValueError(f"unknown engine {engine!r}")


# --- host cycling engine ----------------------------------------------------

def _cycle_host(ml: MultiLevel, cycle: Cycle, x, b, lvl: int):
    """One cycle at level ``lvl`` (multilevel.jl:214-239)."""
    level = ml.levels[lvl]
    level.presmoother.smooth(x, b)

    res = b - level.A @ x
    coarse_b = level.R @ res
    coarse_x = np.zeros_like(coarse_b)

    if lvl == len(ml.levels) - 1:
        ml.coarse_solver(coarse_x, coarse_b)
    else:
        _next_host(ml, cycle, coarse_x, coarse_b, lvl + 1)

    x += level.P @ coarse_x
    level.postsmoother.smooth(x, b)
    return x


def _next_host(ml, cycle, x, b, lvl):
    # Recursion policy (multilevel.jl:200-212).
    if isinstance(cycle, V):
        _cycle_host(ml, cycle, x, b, lvl)
    elif isinstance(cycle, W):
        _cycle_host(ml, cycle, x, b, lvl)
        _cycle_host(ml, cycle, x, b, lvl)
    elif isinstance(cycle, F):
        _cycle_host(ml, cycle, x, b, lvl)
        _cycle_host(ml, V(), x, b, lvl)
    else:
        raise TypeError(f"unknown cycle {cycle!r}")
    return x


def solve_mg(
    ml: MultiLevel,
    b,
    cycle: Cycle = V(),
    *,
    x=None,
    maxiter: int = 100,
    abstol: float = 0.0,
    reltol: Optional[float] = None,
    verbose: bool = False,
    log: bool = False,
    calculate_residual: bool = True,
):
    """Host-engine iteration loop (multilevel.jl:158-198)."""
    b = np.asarray(b)
    if reltol is None:
        reltol = math.sqrt(np.finfo(b.dtype if b.dtype.kind in "fc" else np.float64).eps)
    A = ml.levels[0].A if ml.levels else ml.final_A
    dtype = np.promote_types(A.dtype, b.dtype)
    x = np.zeros(b.shape, dtype=dtype) if x is None else np.asarray(x, dtype=dtype)
    bq = b.astype(dtype, copy=False)

    normres = normb = np.linalg.norm(bq)
    if normb != 0:
        abstol = max(reltol * normb, abstol)
    residuals = [normb]

    itr = 1
    while itr <= maxiter and ((not calculate_residual) or normres > abstol):
        if len(ml) == 1:
            ml.coarse_solver(x, bq)
        else:
            _cycle_host(ml, cycle, x, bq, 0)
        if calculate_residual:
            if verbose:
                print(f"Norm of residual at iteration {itr:6d} is {normres:.4e}")
            normres = np.linalg.norm(bq - A @ x)
            residuals.append(normres)
        itr += 1

    return (x, residuals) if log else x


def operator_complexity(ml: "MultiLevel") -> float:
    """Σ nnz(Aₗ)/nnz(A₁) — module-level form matching the reference's
    qualified usage ``AlgebraicMultigrid.operator_complexity(ml)``
    (multilevel.jl:98-105)."""
    return ml.operator_complexity()


def grid_complexity(ml: "MultiLevel") -> float:
    """Σ nₗ/n₁ (multilevel.jl:107-114)."""
    return ml.grid_complexity()
