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

The CUDA kernel (``csrc/subcycle_kernel.cu``) is one cooperative launch of
K4's recursion (``csrc/tail_levels.cuh``) over level ``start`` and its
tail, level ``start`` planned as a tail level (``tail_tiles``): its down
leg from zero, the tail, its up leg, a level in tiles running each leg
with the color steps in shared memory (``csrc/leg_tile.cuh``, K3's device
code).  ``fused_subcycle_reference`` is
its plain PyTorch version: the plain down leg, the plain tail and the plain
up leg.  ``fused_subcycle`` takes the plain version only for tensors on the
CPU; on a CUDA tensor it launches the kernel or raises.  Its launches count
under ``launches["sub"]`` of ``vcycle_legs``.

Under ``coef_dtype=torch.bfloat16`` the cache stores what the JAX cache
stores (``_build_slabs_jit``): the top level's A, T and S in bf16, rounded
from the working dtype, and its D⁻¹ at the working dtype (unlike the legs
K1–K3, whose planes and D⁻¹ round from float32) — the top level is a tail
level in this — and the tail's own bf16 planes (A, T, S bf16, D⁻¹ and the
coarse operator at the working dtype).  The kernel's ``f32_bf16`` and
``f64_bf16`` entries take them; the plain version expands each plane at
the working dtype, as the JAX kernel does.

Differences from the JAX cache, all TPU layout: the slab-tiled plane
copies ``A1/d1/T1/S1`` (``_build_slabs_jit``), the one-hot lane selectors
(``_lane_sel``, ``SRyT``/``UPyT``) and the VMEM budget loop are gone; the
cache holds the level's full-size leg planes, read in place, and the
hierarchy's tail.
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
    tail_smem,
    tail_tiles,
)
from .vcycle_legs import (
    FusedLegCache,
    build_level_legs,
    check_vector,
    coef_dtype_of,
    fused_down_reference,
    fused_up_reference,
    launches,
    load_library,
    plane_suffix,
    raise_on,
    round_planes,
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


@dataclasses.dataclass(frozen=True)
class FusedSubcycleCache:
    """The top level's factored legs, the tail below it, every level's tile
    (``tail_tiles`` of the top level and the tail's) and, on a card, the
    kernel's descriptor table (the top level, then the tail's levels)."""

    top: FusedLegCache
    tail: FusedTailCache
    tiles: Tuple[Tuple[int, int], ...]
    desc: Optional[torch.Tensor] = None

    @property
    def levels(self) -> Tuple[FusedLegCache, ...]:
        return (self.top,) + tuple(self.tail.levels)

    @property
    def steps(self) -> Tuple[int, ...]:
        return tuple(self.top.steps)


def _reach(offs) -> int:
    return max((max(abs(dx), abs(dy)) for dx, dy in offs), default=0)


def subcycle_smem(cache: FusedSubcycleCache, level_bytes: int) -> int:
    """Dynamic shared memory of a block: the descriptor table, rounded to
    16 bytes (csrc/subcycle_kernel.cu ``table_bytes``), then the largest
    tiled level's tile buffers."""
    table = -(-level_bytes * len(cache.levels) // 16) * 16
    return table + tail_smem(cache.levels, cache.tiles)


def make_fused_subcycle_cache(top: FusedLegCache, tail: FusedTailCache) -> FusedSubcycleCache:
    """Assemble the cache from the top level's leg cache and the tail below
    it, every level's tile planned from the shapes; also the entry of
    ``convert.hierarchy_from_numpy``."""
    if tuple(tail.levels[0].row_dims) != tuple(top.col_dims):
        raise ValueError("the tail does not start at the top level's coarse grid")
    Wx, Wy = top.row_dims
    k = top.k
    if top.dtype != tail.levels[0].dtype or top.A.dtype != tail.levels[0].A.dtype:
        raise ValueError(f"the top level's planes ({top.A.dtype} under {top.dtype}) are not the tail's"
                         f" ({tail.levels[0].A.dtype} under {tail.levels[0].dtype})")
    if tuple(top.col_dims) != (-(-Wx // k), -(-Wy // k)):
        raise ValueError(f"coarse grid {top.col_dims} is not the box-{k} grid of {top.row_dims}")
    if Wx * Wy >= 2**31:
        raise ValueError("the subcycle kernel indexes a level's cells in 32 bits")
    levels = (top,) + tuple(tail.levels)
    tiles = tail_tiles(levels)
    desc = None
    if top.A.device.type == "cuda":
        per, _, _ = _work_layout(levels)
        desc = _descriptor(levels, per, tiles)
    return FusedSubcycleCache(top=top, tail=tail, tiles=tiles, desc=desc)


def build_fused_subcycle_cache(
    levels, ml, start: int, dtype, device, legs: Optional[FusedLegCache] = None,
    tail: Optional[FusedTailCache] = None, max_rows: int = MAX_ROWS, coef_dtype=None,
) -> Optional[FusedSubcycleCache]:
    """The one-call subcycle cache for ``levels[start:]``, or None where the
    JAX builder gives None: ``start`` out of range, more than ``max_rows``
    rows, a level the factored legs do not take (``build_level_legs``: A,
    P and R lattice, a unit A base, box k in {2, 3}, equal symmetric
    multicolor GS/SOR pre/post smoothers, a lattice coloring, the factored
    T and scale), a stencil reach over 2, or no tail from ``start + 1``
    whose first grid is the level's coarse grid.  ``legs`` and ``tail``
    reuse the hierarchy's caches of those levels; without them they are
    built here (the tail with no row limit, as in the JAX package).
    ``coef_dtype=torch.bfloat16`` stores the top level's A, T and S in bf16
    rounded from ``dtype`` with D⁻¹ at ``dtype`` (the JAX cache's), so
    ``legs`` (the legs' own bf16 cache, D⁻¹ rounded too) is not reused
    then; ``tail`` must carry the same planes."""
    coef_dtype = coef_dtype_of(coef_dtype, dtype)
    if not 0 <= start < len(levels):
        return None
    top = levels[start]
    if top.A.shape[0] > max_rows:
        return None
    if legs is None or coef_dtype is not None:
        legs = build_level_legs(top, dtype, device)
    if legs is None or not legs.factored or _reach(legs.offsA) > MAX_REACH:
        return None
    if coef_dtype is not None:
        legs = round_planes(legs, coef_dtype, dinv=False, restriction=False)
    if tail is None:
        tail = build_fused_tail_cache(levels, ml, start + 1, dtype, device, max_rows=10**9, coef_dtype=coef_dtype)
    # the port's K9 runs a factored tail (the JAX kernel shares the tail's
    # non-factored branch, which no hierarchy with a factored top reaches)
    if tail is None or tuple(tail.levels[0].row_dims) != tuple(legs.col_dims):
        return None
    if not all(L.factored for L in tail.levels):
        return None
    return make_fused_subcycle_cache(legs, tail)


# --------------------------------------------------------------------------
# plain version and wrapper
# --------------------------------------------------------------------------


def fused_subcycle_reference(cache: FusedSubcycleCache, b):
    """One V-cycle from zero over the sub-hierarchy in plain PyTorch: the
    down leg from zero, the tail from zero on its coarse rhs, the up leg
    (bf16 planes expanded at the working dtype).  Returns x at ``b``'s
    (padded) length."""
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
    check_vector("b", b, top.A, n, top.dtype)
    suffixes = {plane_suffix(L, "fused_subcycle", dinv_working=True) for L in cache.levels}
    if len(suffixes) != 1 or tail.Mc.dtype != top.dtype:
        raise TypeError(f"fused_subcycle: the levels' planes {suffixes} and Mc {tail.Mc.dtype} differ")
    if cache.desc is None or cache.desc.device != b.device:
        raise ValueError("the subcycle cache was not built on this card")
    lib = load_library()
    levels = cache.levels
    _, (b7, x7), work_len = _work_layout(levels)
    block_cells = lib.amg_tail_block_cells()
    n_grid = sum(1 for L in levels if L.row_dims[0] * L.row_dims[1] > block_cells)
    # every level's r, g, x_mid and the coarse vectors; the top level's x
    # and b are the call's
    work = torch.empty(work_len, dtype=b.dtype, device=b.device)
    x_out = torch.empty_like(b)
    if b.shape[0] > n:
        x_out[n:].zero_()
    err = getattr(lib, f"amg_fused_subcycle_{suffixes.pop()}")(
        cache.desc.data_ptr(), len(levels), n_grid, work.data_ptr(), x_out.data_ptr(), b.data_ptr(),
        tail.Mc.data_ptr(), tail.n7, b7, x7, subcycle_smem(cache, lib.amg_tail_level_bytes()),
        torch.cuda.current_stream(b.device).cuda_stream,
    )
    raise_on(err, "fused_subcycle kernel")
    launches["sub"] += 1
    return x_out
