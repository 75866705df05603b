"""Strategy/config objects — the framework's kwargs-as-API surface.

Parity with the reference's typed strategy values (survey §5.6): smoother
configs (AlgebraicMultigrid.jl ``src/smoother.jl:10-23,92-99,173-180``), cycle tags
(AlgebraicMultigrid.jl ``src/multilevel.jl:116-124``) and their defaults
(θ=0.25 classical / 0.0 symmetric, ω=4/3 prolongation, GS-symmetric
smoothers, max_levels=10, max_coarse=10).

TPU-native addition: every order-dependent smoother takes an ``ordering``:

* ``"natural"``  — the reference's sequential sweep semantics.  Runs as
  C-speed triangular solves on the host engine and as an exact ``lax.scan``
  recurrence on the device engine (conformance path; not TPU-fast).
* ``"multicolor"`` — graph-colored relaxation: rows of one color update
  simultaneously (a true Gauss-Seidel for the color-permuted ordering).
  This is the TPU-native hot path: each color step is a dense-regular
  gather/reduce that XLA maps onto the VPU with no sequential recurrence.

Convergence contracts (not sweep-for-sweep equality) are the behavioural
requirement, per the reference's own tests (test/test_smoothers.jl:15-45).
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "Sweep",
    "SymmetricSweep",
    "ForwardSweep",
    "BackwardSweep",
    "GaussSeidel",
    "Jacobi",
    "SOR",
    "Cycle",
    "V",
    "W",
    "F",
]


class Sweep:
    pass


@dataclasses.dataclass(frozen=True)
class SymmetricSweep(Sweep):
    pass


@dataclasses.dataclass(frozen=True)
class ForwardSweep(Sweep):
    pass


@dataclasses.dataclass(frozen=True)
class BackwardSweep(Sweep):
    pass


@dataclasses.dataclass(frozen=True)
class GaussSeidel:
    """Gauss-Seidel relaxation config (smoother.jl:18-23)."""

    sweep: Sweep = SymmetricSweep()
    iter: int = 1
    ordering: str = "natural"  # "natural" | "multicolor"


@dataclasses.dataclass(frozen=True)
class Jacobi:
    """Weighted-Jacobi relaxation config (smoother.jl:92-99)."""

    omega: float = 0.5
    iter: int = 1


@dataclasses.dataclass(frozen=True)
class SOR:
    """Successive over-relaxation config (smoother.jl:173-180)."""

    omega: float = 1.0
    sweep: Sweep = SymmetricSweep()
    iter: int = 1
    ordering: str = "natural"


class Cycle:
    pass


@dataclasses.dataclass(frozen=True)
class V(Cycle):
    """V-cycle: one recursive visit per level (multilevel.jl:200-202)."""


@dataclasses.dataclass(frozen=True)
class W(Cycle):
    """W-cycle: two recursive W visits per level (multilevel.jl:204-207)."""


@dataclasses.dataclass(frozen=True)
class F(Cycle):
    """F-cycle: one F visit then one V visit per level (multilevel.jl:209-212)."""
