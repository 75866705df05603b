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
* the public API of the JAX package: ``solve``/``init``/``AMGSolver``
  (``engine="torch"``), ``aspreconditioner`` and ``cg``, the preconditioner
  builders, ``PMIS``/``LabelPropAggregation``, ``save_hierarchy``/
  ``load_hierarchy`` (a file written by either package loads in the other);
* the multi-GPU tier (``algebraicmultigrid_tpu_torch.parallel``) on
  ``torch.distributed``, one process per rank: ``solve_sharded`` over any
  hierarchy (its big levels held as row blocks), and the lattice slab tier
  (the halo-exchange SpMV with K8 overlapping the exchange, the
  slab-sharded V/W/F cycle and PCG, ``rap_planes_sharded``);
  ``algebraicmultigrid_tpu_torch.entry`` has its entry points (one V-cycle, a
  multi-GPU dry run).
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
from .models.aggregate import StandardAggregation
from .models.aggregation import fit_candidates, smoothed_aggregation
from .models.api import AMGSolver, RugeStubenAMG, SmoothedAggregationAMG, init, solve
from .models.classical import ruge_stuben
from .models.coarse import LinearSolveWrapper, Pinv, QRSolver, SpluSolver
from .models.device import (
    build_device_hierarchy,
    cg_device,
    device_cycle_fn,
    get_device_hierarchy,
    solve_device,
    solve_refined,
)
from .models.fastsetup import structured_ruge_stuben, structured_smoothed_aggregation
from .models.gallery import poisson, stencil_grid
from .models.interpolation import direct_interpolation
from .models.lattice import LatticeMatrix, LatticeProblem
from .models.lattice_nd import (
    BoxAggregationND,
    LatticeMatrixND,
    LatticeProblemND,
    structured_smoothed_aggregation_nd,
)
from .models.multilevel import Level, MultiLevel, grid_complexity, operator_complexity, solve_mg
from .models.parallel_setup import LabelPropAggregation, PMIS
from .models.preconditioner import Preconditioner, aspreconditioner
from .models.precs import RugeStubenPreconBuilder, SmoothedAggregationPreconBuilder
from .models.prolongation_smooth import JacobiProlongation
from .models.splitting import RS, rs_cf_splitting
from .models.strength import Classical, SymmetricStrength
from .models.structured import StructuredAggregation, StructuredRS
from .ops.krylov import cg
from .utils.arnoldi import approximate_spectral_radius
from .utils.serialize import load_hierarchy, save_hierarchy
from .utils.symmetry import HermitianSymmetry, NoSymmetry

__version__ = "0.1.0"

__all__ = [
    # cycles & sweeps
    "Cycle", "V", "W", "F", "Sweep", "SymmetricSweep", "ForwardSweep", "BackwardSweep",
    # smoothers
    "GaussSeidel", "Jacobi", "SOR",
    # strength / splitting / aggregation
    "Classical", "SymmetricStrength", "RS", "StructuredRS", "rs_cf_splitting",
    "StandardAggregation", "StructuredAggregation", "fit_candidates",
    "PMIS", "LabelPropAggregation",
    "JacobiProlongation",
    "direct_interpolation",
    # hierarchy
    "ruge_stuben", "smoothed_aggregation", "Level", "MultiLevel", "solve_mg",
    "operator_complexity", "grid_complexity",
    # coarse solvers
    "Pinv", "QRSolver", "LinearSolveWrapper", "SpluSolver",
    # preconditioner / Krylov
    "Preconditioner", "aspreconditioner", "cg", "cg_device", "solve_refined",
    "RugeStubenPreconBuilder", "SmoothedAggregationPreconBuilder",
    # CommonSolve-style API
    "AMGSolver", "RugeStubenAMG", "SmoothedAggregationAMG", "solve", "init",
    # lattice fast path
    "LatticeMatrix", "LatticeProblem", "structured_ruge_stuben",
    "structured_smoothed_aggregation",
    "LatticeMatrixND", "LatticeProblemND", "BoxAggregationND",
    "structured_smoothed_aggregation_nd",
    # gallery & utils
    "poisson", "stencil_grid", "approximate_spectral_radius",
    "HermitianSymmetry", "NoSymmetry",
    "save_hierarchy", "load_hierarchy",
    # the torch engine
    "build_device_hierarchy", "get_device_hierarchy", "solve_device", "device_cycle_fn",
]
