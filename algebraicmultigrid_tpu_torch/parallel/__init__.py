"""The multi-GPU tier on ``torch.distributed``, one process per rank (SPMD):
the generic sharded hierarchy (``solve_sharded``: any hierarchy, its big
levels held as row blocks), the slab-sharded lattice tier (x-slabs,
nearest-neighbour halo exchange, the slab V/W/F cycle and PCG) and the
probing Galerkin product on slabs (``rap_planes_sharded``).  Port of the
JAX package's ``parallel/``."""

from .dist import (
    RowMesh,
    build_sharded_hierarchy,
    make_row_mesh,
    run_ranks,
    shard_hierarchy,
    solve_sharded,
)
from .halo import lat2d_spmv_halo, shard_slab
from .lattice_cycle import (
    SlabHierarchy,
    build_slab_hierarchy,
    cycle_lattice_sharded,
    matvec_lattice_sharded,
    solve_lattice_sharded,
)
from .sharded_rap import rap_planes_sharded

__all__ = [
    "RowMesh",
    "make_row_mesh",
    "run_ranks",
    "shard_hierarchy",
    "build_sharded_hierarchy",
    "solve_sharded",
    "lat2d_spmv_halo",
    "shard_slab",
    "SlabHierarchy",
    "build_slab_hierarchy",
    "cycle_lattice_sharded",
    "matvec_lattice_sharded",
    "solve_lattice_sharded",
    "rap_planes_sharded",
]
