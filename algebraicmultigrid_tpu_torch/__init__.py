"""algebraicmultigrid_tpu_torch — the PyTorch / CUDA port of algebraicmultigrid_tpu.

The host setup tier (numpy/scipy) is a copy of the JAX package's, so both
packages build identical hierarchies; the device tier runs on PyTorch, with
the JAX package's Pallas kernels as hand-written CUDA kernels for Hopper
(``ops/kernels/``, ``csrc/``).  This package never imports JAX.

Covered so far:

* the structured smoothed-aggregation Poisson solve on Lat2D levels —
  ``poisson((N, N), lattice=True)`` → ``structured_smoothed_aggregation``
  → ``cg_device`` / ``solve_refined``;
* structured Ruge–Stüben on 2-D lattice problems — ``ruge_stuben(poisson((N,
  N), lattice=True), CF=StructuredRS())`` (``structured_ruge_stuben``):
  semi-coarsened Lat2D levels, smoothed by the whole-sweep kernel K5;
* 3-D lattice problems — ``poisson((N, N, N), lattice=True)`` →
  ``structured_smoothed_aggregation_nd`` → LatND levels smoothed by the
  whole-sweep kernel K7;
* any scipy matrix — ``smoothed_aggregation(A)`` / ``ruge_stuben(A)`` →
  ``build_device_hierarchy`` (SDIA, BT, dense, BSG or ELL levels, with the
  RCM basis where it helps) → ``cg_device`` / ``solve_device`` /
  ``solve_refined`` / ``device_cycle_fn``; the drivers and
  ``ml.solve(B, engine="torch")`` take a multi-RHS B of shape [n, k];
* the multi-GPU lattice tier (``algebraicmultigrid_tpu_torch.parallel``) on
  ``torch.distributed``: one process per x-slab, the halo-exchange SpMV
  with K8 overlapping the exchange, the slab-sharded V/W/F cycle and PCG.
"""

from .config import (
    BackwardSweep,
    Cycle,
    F,
    ForwardSweep,
    GaussSeidel,
    Jacobi,
    SOR,
    Sweep,
    SymmetricSweep,
    V,
    W,
)
from .models.aggregation import smoothed_aggregation
from .models.classical import ruge_stuben
from .models.device import (
    build_device_hierarchy,
    cg_device,
    device_cycle_fn,
    get_device_hierarchy,
    solve_device,
    solve_refined,
)
from .models.fastsetup import structured_ruge_stuben, structured_smoothed_aggregation
from .models.gallery import poisson
from .models.lattice import LatticeMatrix, LatticeProblem
from .models.lattice_nd import (
    BoxAggregationND,
    LatticeMatrixND,
    LatticeProblemND,
    structured_smoothed_aggregation_nd,
)
from .models.multilevel import MultiLevel, operator_complexity
from .models.structured import StructuredAggregation, StructuredRS

__version__ = "0.1.0"

__all__ = [
    "Cycle", "V", "W", "F", "Sweep", "SymmetricSweep", "ForwardSweep", "BackwardSweep",
    "GaussSeidel", "Jacobi", "SOR",
    "StructuredAggregation", "StructuredRS", "smoothed_aggregation", "structured_smoothed_aggregation",
    "structured_smoothed_aggregation_nd", "ruge_stuben", "structured_ruge_stuben",
    "MultiLevel", "operator_complexity", "LatticeMatrix", "LatticeProblem", "LatticeMatrixND",
    "LatticeProblemND", "BoxAggregationND", "poisson",
    "build_device_hierarchy", "get_device_hierarchy", "cg_device", "solve_refined",
    "solve_device", "device_cycle_fn",
]
