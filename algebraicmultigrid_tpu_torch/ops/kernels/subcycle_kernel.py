"""Phased whole-subcycle V-cycle (K9): one V-cycle from the zero guess over
the levels ``[start, end]``, in one call.

Port of the JAX package's ``ops/pallas/subcycle_kernel.py``: the factored
presmooth, residual and restriction of level ``start`` (the down leg K1
from zero), the whole-tail recursion K4 of every deeper level plus the dense
coarse solve, and the factored prolong-correct and postsmooth of level
``start`` (the up leg K2).  The hierarchy runs it at ``sub_start =
tail_start − 1`` when built with ``subcycle=True`` (the JAX package's
``AMG_PALLAS_SUB=1``), in every V-cycle and in every ``run_fixed_cycles``
iteration.

The CUDA kernel (``csrc/subcycle_kernel.cu``) is one cooperative launch in
three phases: level ``start`` in 2-D tiles with the color steps in shared
memory, the tail recursion of ``csrc/tail_levels.cuh`` (K4's code), then
level ``start`` again in the same tiles.  ``fused_subcycle_reference`` is
its plain PyTorch version: the plain down leg, the plain tail and the plain
up leg.  ``fused_subcycle`` takes the plain version only for tensors on the
CPU; on a CUDA tensor it launches the kernel or raises.  Its launches count
under ``launches["sub"]`` of ``vcycle_legs``.

Differences from the JAX cache, all TPU layout: the slab-tiled plane
copies ``A1/d1/T1/S1`` (``_build_slabs_jit``), the one-hot lane selectors
(``_lane_sel``) and the VMEM budget loop are gone; the cache holds the
level's full-size leg planes, read in place, and the hierarchy's tail.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .tail_kernel import (
    FusedTailCache,
    _descriptor,
    _work_layout,
    build_fused_tail_cache,
    fused_tail_reference,
)
from .vcycle_legs import (
    FusedLegCache,
    SUFFIX,
    build_level_legs,
    check_vector,
    fused_down_reference,
    fused_up_reference,
    launches,
    load_library,
    raise_on,
)

__all__ = [
    "FusedSubcycleCache",
    "build_fused_subcycle_cache",
    "make_fused_subcycle_cache",
    "fused_subcycle",
    "fused_subcycle_reference",
]

# the JAX package's AMG_SUB_MAX_ROWS default
MAX_ROWS = 2_500_000
# the JAX gate's limit on the level's stencil reach
MAX_REACH = 2
# edge of a tile's interior (rounded down to a multiple of k); shrunk until
# phase A's shared memory fits a block.  K9 at L1 of 4096² on an H100
# (kernel_variants.py subcycle, f32): 1.03 ms with 72, 1.10 with 96, 1.13
# with 48, 1.24 with 36, 1.63 with 24
TILE = 72


@dataclasses.dataclass(frozen=True)
class FusedSubcycleCache:
    """The top level's factored legs, the tail below it and, on a card, the
    kernel's descriptor table (the top level, then the tail's levels)."""

    top: FusedLegCache
    tail: FusedTailCache
    steps: Tuple[int, ...]
    reach: int
    tile: int = TILE
    desc: Optional[torch.Tensor] = None

    @property
    def halos(self) -> Tuple[int, int]:
        """(phase A, phase C) halo of a tile: A needs x exact two reaches
        beyond the tile (r and g, then T(r − A·g)); C's correction is exact
        on the whole box, so only the color steps erode it."""
        grown = len(self.steps) * self.reach
        return grown + 2 * self.reach, grown


def _reach(offs) -> int:
    return max((max(abs(dx), abs(dy)) for dx, dy in offs), default=0)


def _smem_bytes(tile: int, steps: int, reach: int, itemsize: int, table: int) -> int:
    """Dynamic shared memory of a block: the descriptor table, then phase
    A's box of x plus r and g over the tile and one reach (phase C's box is
    smaller)."""
    ed = tile + 2 * (steps * reach + 2 * reach)
    g = tile + 2 * reach
    return table + (ed * ed + 2 * g * g) * itemsize


def make_fused_subcycle_cache(top: FusedLegCache, tail: FusedTailCache, tile: int = TILE) -> FusedSubcycleCache:
    """Assemble the cache from the top level's leg cache and the tail below
    it; also the entry of ``convert.hierarchy_from_numpy``.  On a card the
    tile shrinks (by k) until phase A's shared memory fits a block."""
    if tuple(tail.levels[0].row_dims) != tuple(top.col_dims):
        raise ValueError("the tail does not start at the top level's coarse grid")
    Wx, Wy = top.row_dims
    Wxc, Wyc = top.col_dims
    k = top.k
    if (Wxc, Wyc) != (-(-Wx // k), -(-Wy // k)):
        raise ValueError(f"coarse grid {top.col_dims} is not the box-{k} grid of {top.row_dims}")
    if Wx * Wy >= 2**31:
        raise ValueError("the subcycle kernel indexes a level's cells in 32 bits")
    steps = tuple(top.steps)
    reach = _reach(top.offsA)
    tile = max(k, tile - tile % k)
    desc = None
    if top.A.device.type == "cuda":
        lib = load_library()
        table = lib.amg_tail_level_bytes() * (len(tail.levels) + 1)
        itemsize = top.A.element_size()
        while tile > k and _smem_bytes(tile, len(steps), reach, itemsize, table) > lib.amg_subcycle_smem_limit():
            tile -= k
        per, _, _ = _work_layout(tail.levels)
        desc = _descriptor((top,) + tuple(tail.levels), [(0, 0, 0, 0)] + per)
    return FusedSubcycleCache(top=top, tail=tail, steps=steps, reach=reach, tile=tile, desc=desc)


def build_fused_subcycle_cache(
    levels, ml, start: int, dtype, device, legs: Optional[FusedLegCache] = None,
    tail: Optional[FusedTailCache] = None, max_rows: int = MAX_ROWS,
) -> Optional[FusedSubcycleCache]:
    """The one-call subcycle cache for ``levels[start:]``, or None where the
    JAX builder gives None: ``start`` out of range, more than ``max_rows``
    rows, a level the factored legs do not take (``build_level_legs``: A,
    P and R lattice, a unit A base, box k in {2, 3}, equal symmetric
    multicolor GS/SOR pre/post smoothers, a lattice coloring, the factored
    T and scale), a stencil reach over 2, or no tail from ``start + 1``
    whose first grid is the level's coarse grid.  ``legs`` and ``tail``
    reuse the hierarchy's caches of those levels; without them they are
    built here (the tail with no row limit, as in the JAX package)."""
    if not 0 <= start < len(levels):
        return None
    top = levels[start]
    if top.A.shape[0] > max_rows:
        return None
    if legs is None:
        legs = build_level_legs(top, dtype, device)
    if legs is None or _reach(legs.offsA) > MAX_REACH:
        return None
    if tail is None:
        tail = build_fused_tail_cache(levels, ml, start + 1, dtype, device, max_rows=10**9)
    if tail is None or tuple(tail.levels[0].row_dims) != tuple(legs.col_dims):
        return None
    return make_fused_subcycle_cache(legs, tail)


# --------------------------------------------------------------------------
# plain version and wrapper
# --------------------------------------------------------------------------


def fused_subcycle_reference(cache: FusedSubcycleCache, b):
    """One V-cycle from zero over the sub-hierarchy in plain PyTorch: the
    down leg from zero, the tail from zero on its coarse rhs, the up leg.
    Returns x at ``b``'s (padded) length."""
    x, bc = fused_down_reference(cache.top, torch.zeros_like(b), b, x_zero=True)
    xc = fused_tail_reference(cache.tail, torch.zeros_like(bc), bc, x_zero=True)
    return fused_up_reference(cache.top, x, b, xc)


def fused_subcycle(cache: FusedSubcycleCache, b):
    """x = one V-cycle from the zero guess over the sub-hierarchy, the
    coarse-level recursion's cycle at ``sub_start``.  Returns x at ``b``'s
    (padded) length."""
    if b.device.type == "cpu":
        return fused_subcycle_reference(cache, b)
    if b.device.type != "cuda":
        raise ValueError(f"fused_subcycle runs on cuda or cpu tensors, not {b.device}")
    top, tail = cache.top, cache.tail
    n = top.row_dims[0] * top.row_dims[1]
    check_vector("b", b, top.A, n)
    if b.dtype not in SUFFIX:
        raise TypeError(f"fused_subcycle takes float32 or float64, not {b.dtype}")
    if cache.desc is None or cache.desc.device != b.device:
        raise ValueError("the subcycle cache was not built on this card")
    lib = load_library()
    _, (b7, x7), work_len = _work_layout(tail.levels)
    block_cells = lib.amg_tail_block_cells()
    n_grid = sum(1 for L in tail.levels if L.row_dims[0] * L.row_dims[1] > block_cells)
    nt = tail.levels[0].row_dims[0] * tail.levels[0].row_dims[1]
    # one scratch buffer: the tail's work, then x_mid, b_c and x_c
    scratch = torch.empty(work_len + n + 2 * nt, dtype=b.dtype, device=b.device)
    x_mid, bc, xc = torch.split(scratch[work_len:], [n, nt, nt])
    x_out = torch.empty_like(b)
    if b.shape[0] > n:
        x_out[n:].zero_()
    hd, hu = cache.halos
    err = getattr(lib, f"amg_fused_subcycle_{SUFFIX[b.dtype]}")(
        cache.desc.data_ptr(), len(tail.levels), n_grid, scratch.data_ptr(), x_out.data_ptr(),
        b.data_ptr(), x_mid.data_ptr(), bc.data_ptr(), xc.data_ptr(), tail.Mc.data_ptr(), tail.n7,
        b7, x7, cache.tile, top.k, hd, hu, cache.reach,
        torch.cuda.current_stream(b.device).cuda_stream,
    )
    raise_on(err, "fused_subcycle kernel")
    launches["sub"] += 1
    return x_out
