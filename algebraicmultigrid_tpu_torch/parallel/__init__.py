"""The multi-GPU lattice tier on ``torch.distributed``: one process per
x-slab (SPMD), nearest-neighbour halo exchange, the slab-sharded V/W/F cycle
and PCG.  Port of the JAX package's ``parallel/`` slab tier; the generic
``dist.py`` rows (``shard_hierarchy``, ``build_sharded_hierarchy``,
``solve_sharded``) and ``sharded_rap.py`` are not ported yet."""

from .dist import RowMesh, make_row_mesh, run_ranks
from .halo import lat2d_spmv_halo, shard_slab
from .lattice_cycle import (
    SlabHierarchy,
    build_slab_hierarchy,
    cycle_lattice_sharded,
    matvec_lattice_sharded,
    solve_lattice_sharded,
)

__all__ = [
    "RowMesh",
    "make_row_mesh",
    "run_ranks",
    "lat2d_spmv_halo",
    "shard_slab",
    "SlabHierarchy",
    "build_slab_hierarchy",
    "cycle_lattice_sharded",
    "matvec_lattice_sharded",
    "solve_lattice_sharded",
]
