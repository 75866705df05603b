"""High-level solve API (CommonSolve-style).

Parity with AlgebraicMultigrid.jl ``src/multilevel.jl:241-264``: algorithm tags
``RugeStubenAMG`` / ``SmoothedAggregationAMG``; ``solve(A, b, alg; kwargs)``
runs ``init`` (hierarchy setup) then ``solve!`` (cycling), with kwargs
forwarded to **both** phases — setup kwargs are swallowed by the solve and
vice versa, exactly like the reference's trailing ``kwargs...``.  A copy of
the JAX package's module; the solve side also takes the torch engine's
``device``, ``coef_dtype`` and ``subcycle`` (``engine="torch"``), which the
setup drivers would otherwise swallow.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from ..config import Cycle, V
from .aggregation import smoothed_aggregation
from .classical import ruge_stuben
from .multilevel import MultiLevel

__all__ = ["AMGSolver", "RugeStubenAMG", "SmoothedAggregationAMG", "init", "solve"]

_SOLVE_KWARGS = {
    "maxiter",
    "abstol",
    "reltol",
    "verbose",
    "log",
    "calculate_residual",
    "x",
    "engine",
    "dtype",
    # the torch engine's solve-side keywords (solve_device)
    "device",
    "coef_dtype",
    "subcycle",
}


@dataclasses.dataclass
class AMGSolver:
    ml: MultiLevel
    b: np.ndarray

    def solve(self, cycle: Cycle = V(), **kwargs):
        return self.ml.solve(self.b, cycle, **kwargs)


class AMGAlg:
    pass


@dataclasses.dataclass(frozen=True)
class RugeStubenAMG(AMGAlg):
    pass


@dataclasses.dataclass(frozen=True)
class SmoothedAggregationAMG(AMGAlg):
    pass


def init(alg: AMGAlg, A, b, **kwargs) -> AMGSolver:
    setup_kwargs = {k: v for k, v in kwargs.items() if k not in _SOLVE_KWARGS}
    if isinstance(alg, RugeStubenAMG):
        ml = ruge_stuben(A, **setup_kwargs)
    elif isinstance(alg, SmoothedAggregationAMG):
        ml = smoothed_aggregation(A, **setup_kwargs)
    else:
        raise TypeError(f"unknown AMG algorithm {alg!r}")
    return AMGSolver(ml, np.asarray(b))


def solve(A, b, alg: AMGAlg, cycle: Cycle = V(), **kwargs):
    """One-call setup + solve (multilevel.jl:252-255)."""
    solver = init(alg, A, b, **kwargs)
    solve_kwargs = {k: v for k, v in kwargs.items() if k in _SOLVE_KWARGS}
    return solver.solve(cycle, **solve_kwargs)
