"""Whole-tail V-cycle (K4) on the trailing run of small Lat2D levels.

Port of the JAX package's ``ops/pallas/tail_kernel.py`` in its factored
form: one call runs the V-cycle of every level from ``start`` down — for each
level the presmooth color steps, the residual and the factored restriction,
the recursion from the zero guess, the correction and the postsmooth — with
the dense coarse solve x_c = Mc·b_c at the bottom (Mc = R⁻¹Qᵀ, or the
pseudo-inverse when the coarse operator is singular).

The CUDA kernel (``csrc/tail_kernel.cu``) is one cooperative launch per
call: the levels of more than ``BLOCK_CELLS`` cells run each leg as one
phase of independent tiles (the tile plus a halo in shared memory, K3's
device code, planned here from the shapes), one grid barrier a leg, and the
smaller levels and the coarse solve run inside one block, pass by pass.
``fused_tail_reference`` is its plain PyTorch version, the recursion of the
plain legs.  Under ``coef_dtype=torch.bfloat16`` every level's A, T and S
are bf16 (rounded from the working dtype) and D⁻¹ and the coarse operator
stay at the working dtype, as in the JAX package's tail cache; the
kernel's ``f32_bf16`` and ``f64_bf16`` entries convert each coefficient to
the vectors' type where they load it.  ``fused_tail`` takes the plain version only for tensors
on the CPU; on a CUDA tensor it launches the kernel or raises.  Its launches
count under ``launches["tail"]`` of ``vcycle_legs``.

Non-factored levels (the JAX ``_tail_go``'s ``else`` branches): a tail
level without the factored stash keeps its R planes (at the working dtype,
under bf16 planes too, as the JAX tail cache keeps them) and its P planes
(bf16 under bf16 planes), and restricts and corrects through them; such a
tail runs the kernel's ``amg_fused_tail_nf_*`` entry
(``csrc/tail_nf_kernel.cu``), with the levels' R/P planes and up tiles in
a second descriptor table (``transfers``), and counts under
``launches["tail_nf"]``.  Its grid levels take K1's and K2's non-factored
tiles (``plan_down_nf``, ``plan_up_nf``; ``up_tiles``), one grid barrier a
leg; a level the plan gives no tile runs pass by pass.

Differences from the JAX cache builder, all TPU layout: the planes stay
unpadded (the kernel guards reads outside the grid to zero), so the ``_H``
halo and the one-hot selector matrices are gone, and so is the VMEM audit
(``AMG_TAIL_VMEM_MB``): the tail lives in device memory and L2.  The gate on
levels is the JAX package's (``_level_ok``, ``_factored_spec``,
``_scale_plane``, final level ≤ 4096 rows; the legs' part of it is
``build_level_legs``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .vcycle_legs import (
    MAX_STEPS,
    FusedLegCache,
    _offsets,
    build_level_legs,
    check_vector,
    coef_dtype_of,
    fused_down_reference,
    fused_up_reference,
    launches,
    leg_halo,
    load_library,
    nf_tile_smem_bytes,
    plan_down_nf,
    plan_tile,
    plan_up_nf,
    plane_suffix,
    raise_on,
    round_planes,
    stencil_args,
    tile_smem_bytes,
)

__all__ = [
    "FusedTailCache",
    "build_fused_tail_cache",
    "make_fused_tail_cache",
    "fused_tail",
    "fused_tail_reference",
    "tail_smem",
    "tail_tiles",
    "tail_up_tiles",
]

MAX_COARSE_ROWS = 4096
# the kernel's descriptor-table capacity (kMaxTailLevels, csrc/tail_kernel.cu)
MAX_LEVELS = 16
# reach limits of the JAX gate (its 8-cell halo), kept so both packages
# pick the same tail
_H = 8
# levels of more cells run on the whole grid (csrc/tail_levels.cuh
# kBlockCells), in tiles of this size (cut to the register box and rounded
# down to multiples of k: 45 x 45 for the 9-point levels of 4096², one tile
# a block at 456²), chosen by kernel_variants.py
BLOCK_CELLS = 4096
TAIL_TILE = (48, 48)


@dataclasses.dataclass(frozen=True)
class FusedTailCache:
    """The tail's levels (fine → coarse), its coarse solve operator and, on a
    card, the kernel's descriptor table."""

    levels: Tuple[FusedLegCache, ...]
    Mc: torch.Tensor       # [n7, n7] dense coarse solve operator
    dims7: Tuple[int, int]  # coarse grid (W7x, W7y)
    work_len: int          # elements of the kernel's work buffer
    # per level its tile (a non-factored level's down leg's), (0, 0) where
    # the level runs pass by pass (in one block, or on the grid where the
    # plan gives none)
    tiles: Tuple[Tuple[int, int], ...] = ()
    # per level a tiled non-factored level's up leg's tile, else (0, 0)
    up_tiles: Tuple[Tuple[int, int], ...] = ()
    desc: Optional[torch.Tensor] = None  # uint8 LevelDesc table (CUDA only)
    # uint8 Transfer table of the levels' R/P planes and up tiles (CUDA
    # only; None when every level is factored)
    transfers: Optional[torch.Tensor] = None

    @property
    def factored(self) -> bool:
        """Every level factored (the kernel's factored entries)."""
        return all(L.factored for L in self.levels)

    @property
    def n7(self) -> int:
        return self.dims7[0] * self.dims7[1]

    @property
    def smem(self) -> int:
        """Bytes of dynamic shared memory the tiled levels take."""
        return tail_smem(self.levels, self.tiles, self.up_tiles)


def tail_tiles(levels):
    """Each level's tile, for the levels of more than ``BLOCK_CELLS`` cells
    (the grid levels): a factored level's in tiles of about ``TAIL_TILE``
    (``plan_tile``: a 5- or 9-point level whose box fits the register map),
    a non-factored level's down leg's from ``plan_down_nf`` (K1's plan);
    else (0, 0): the level runs pass by pass."""
    out = []
    for L in levels:
        tile = None
        if L.row_dims[0] * L.row_dims[1] > BLOCK_CELLS:
            if L.factored:
                halo = leg_halo(len(L.steps), L.reach, True)
                tile = plan_tile(L.row_dims, L.k, len(L.offsA), halo, TAIL_TILE)
            else:
                tile = plan_down_nf(L.row_dims, L.k, L.offsA, L.offsR, len(L.steps))
        out.append(tile or (0, 0))
    return tuple(out)


def tail_up_tiles(levels, tiles):
    """Each non-factored level's up leg's tile where ``tiles`` tiles it,
    from ``plan_up_nf`` (K2's plan; its halo is smaller than the down leg's,
    so it fits where that does), else (0, 0)."""
    return tuple(
        (0, 0) if L.factored or t[0] == 0 else plan_up_nf(L.row_dims, L.k, L.offsA, len(L.steps))
        for L, t in zip(levels, tiles)
    )


def tail_smem(levels, tiles, up_tiles=None) -> int:
    """The largest tiled leg's tile buffers, in bytes (vectors only, at the
    working dtype): a factored level's down leg's (the up leg's halo is
    smaller), a non-factored level's down and up legs' (``up_tiles``)."""
    up_tiles = up_tiles or ((0, 0),) * len(levels)
    sizes = [0]
    for L, t, u in zip(levels, tiles, up_tiles):
        if t[0] == 0:
            continue
        n, item = len(L.steps), L.dtype.itemsize
        if L.factored:
            sizes.append(tile_smem_bytes(*t, leg_halo(n, L.reach, True), L.reach, item))
        else:
            sizes.append(nf_tile_smem_bytes(True, t, n, L.reach, L.offsR, L.k, item))
            sizes.append(nf_tile_smem_bytes(False, u, n, L.reach, L.offsP, L.k, item))
    return max(sizes)


def _work_layout(levels):
    """Element offsets (x, b, r, g, x_mid) per level and (b7, x7) in one
    work buffer; level 0's x and b are the call's own vectors."""
    off = 0
    per = []
    for i, L in enumerate(levels):
        n = L.row_dims[0] * L.row_dims[1]
        xo = bo = 0
        if i > 0:
            xo, bo = off, off + n
            off += 2 * n
        per.append((xo, bo, off, off + n, off + 2 * n))
        off += 3 * n
    n7 = levels[-1].col_dims[0] * levels[-1].col_dims[1]
    return per, (off, off + n7), off + 2 * n7


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _descriptor(levels, per, tiles) -> torch.Tensor:
    """The kernels' LevelDesc table, filled by the library and copied to the
    card once."""
    lib = load_library()
    size = lib.amg_tail_level_bytes()
    table = (ctypes.c_char * (size * len(levels)))()
    for i, (L, offs, tile) in enumerate(zip(levels, per, tiles)):
        err = lib.amg_tail_fill_level(
            ctypes.addressof(table), i,
            L.A.data_ptr(), L.dinv.data_ptr(), _ptr(L.T), _ptr(L.S),
            *offs, *L.row_dims, *L.col_dims, L.k, *tile, *stencil_args(L, L.steps),
        )
        raise_on(err, f"tail descriptor of level {i}")
    host = torch.frombuffer(bytearray(table), dtype=torch.uint8)
    return host.to(levels[0].A.device)


def _transfers(levels, up_tiles) -> torch.Tensor:
    """The kernel's Transfer table: each non-factored level's R/P planes,
    offsets and up tile, a factored level's entry zero; copied to the card
    once."""
    lib = load_library()
    size = lib.amg_tail_transfer_bytes()
    table = (ctypes.c_char * (size * len(levels)))()
    for i, (L, up) in enumerate(zip(levels, up_tiles)):
        if L.factored:
            continue
        err = lib.amg_tail_fill_transfer(
            ctypes.addressof(table), i, L.R.data_ptr(), L.P.data_ptr(), *_offsets(L.offsR), *_offsets(L.offsP), *up,
        )
        raise_on(err, f"tail transfer of level {i}")
    host = torch.frombuffer(bytearray(table), dtype=torch.uint8)
    return host.to(levels[0].A.device)


def make_fused_tail_cache(levels, Mc: torch.Tensor, tiles=None) -> FusedTailCache:
    """Assemble the cache from per-level leg caches (fine → coarse) and the
    coarse operator, with the grid levels' tiles planned from the shapes
    (``tail_tiles``, the non-factored up legs' ``tail_up_tiles``), or
    ``tiles``: per level the plan's tile or (0, 0), the level pass by pass
    (the route the tiles replaced); also the entry of
    ``convert.hierarchy_from_numpy``."""
    levels = tuple(levels)
    if not levels or len(levels) > MAX_LEVELS:
        raise ValueError(f"a tail has 1..{MAX_LEVELS} levels, got {len(levels)}")
    for a, b in zip(levels, levels[1:]):
        if tuple(a.col_dims) != tuple(b.row_dims):
            raise ValueError("tail levels do not chain: coarse dims != next level's dims")
    if levels[0].row_dims[0] * levels[0].row_dims[1] >= 2**31:
        raise ValueError("the tail kernel indexes a level's cells in 32 bits")
    dims7 = tuple(levels[-1].col_dims)
    n7 = dims7[0] * dims7[1]
    if tuple(Mc.shape) != (n7, n7):
        raise ValueError(f"coarse operator {tuple(Mc.shape)} does not fit the grid {dims7}")
    per, _, work_len = _work_layout(levels)
    planned = tail_tiles(levels)
    tiles = planned if tiles is None else tuple(tuple(t) for t in tiles)
    if len(tiles) != len(levels) or any(t not in (p, (0, 0)) for t, p in zip(tiles, planned)):
        raise ValueError(f"tail tiles {tiles}: each level's is the plan's {planned} or (0, 0)")
    up_tiles = tail_up_tiles(levels, tiles)
    cuda = Mc.device.type == "cuda"
    desc = _descriptor(levels, per, tiles) if cuda else None
    transfers = _transfers(levels, up_tiles) if cuda and not all(L.factored for L in levels) else None
    return FusedTailCache(
        levels=levels, Mc=Mc.contiguous(), dims7=dims7, work_len=work_len, tiles=tiles, up_tiles=up_tiles,
        desc=desc, transfers=transfers,
    )


# --------------------------------------------------------------------------
# the gate and the cache builder
# --------------------------------------------------------------------------


def _reach_ok(level, k: int) -> bool:
    """The JAX tail gate's limits beyond the legs' own (``_level_ok``: R
    offsets within [−k, 2k), P and A reach within its halo), kept so both
    packages pick the same tail."""
    sA, sR, sP = level.A.spec, level.R.spec, level.P.spec
    return (
        all(-k <= dx < 2 * k and -k <= dy < 2 * k for dx, dy in sR.offsets)
        and max((max(abs(dx), abs(dy)) for dx, dy in sP.offsets), default=0) <= _H // 2
        and max((max(abs(dx), abs(dy)) for dx, dy in sA.offsets), default=0) < _H
    )


def _coarse_operator(ml) -> np.ndarray:
    """Mc with x = Mc·b the coarse solve: R⁻¹Qᵀ, or the pseudo-inverse
    (coarse_solver.jl:9-16,66-81 semantics)."""
    from ...models.coarse import QRSolver

    cs = ml.coarse_solver
    if isinstance(cs, QRSolver) and not cs._singular and cs.Q is not None:
        import scipy.linalg as sla

        return sla.solve_triangular(np.asarray(cs.R), np.asarray(cs.Q).conj().T, lower=False)
    if getattr(cs, "pinvA", None) is not None:
        return np.asarray(cs.pinvA)
    return np.linalg.pinv(np.asarray(ml.final_A.toarray()))


def build_fused_tail_cache(levels, ml, start: int, dtype, device, max_rows: int = 250_000, coef_dtype=None):
    """The whole-tail cache for ``levels[start:]`` plus the coarse solve, or
    None when the tail's first level has more than ``max_rows`` rows or any
    tail level fails the gate: fused legs as ``build_level_legs`` builds
    them, the JAX tail's reach limits, at most 64 color steps a leg (the
    kernel's descriptor), chained grids, and a final grid of at most 4096
    rows.  A level without the factored stash takes its R and P planes.
    ``coef_dtype=torch.bfloat16`` rounds each level's A, T, S and P from
    ``dtype`` to bf16; D⁻¹ and R stay at ``dtype`` (D⁻¹ from the level's own
    diagonal, not from a bf16 leg cache), as in the JAX package's tail
    cache under float32 and float64."""
    coef_dtype = coef_dtype_of(coef_dtype, dtype)
    tail = levels[start:]
    if not tail or tail[0].A.shape[0] > max_rows or len(tail) > MAX_LEVELS:
        return None
    legs = []
    for level in tail:
        leg = build_level_legs(level, dtype, device)
        if leg is None or not _reach_ok(level, leg.k) or (legs and legs[-1].col_dims != leg.row_dims):
            return None
        if len(leg.steps) > MAX_STEPS:  # the kernel's descriptor holds 64
            return None
        legs.append(leg if coef_dtype is None else round_planes(leg, coef_dtype, dinv=False, restriction=False))
    W7x, W7y = legs[-1].col_dims
    if ml.final_A.shape[0] != W7x * W7y or W7x * W7y > MAX_COARSE_ROWS:
        return None
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    Mc = torch.as_tensor(_coarse_operator(ml).astype(np_dtype), device=device)
    return make_fused_tail_cache(legs, Mc)


# --------------------------------------------------------------------------
# plain version and wrapper
# --------------------------------------------------------------------------


def _tail_go(cache: FusedTailCache, lvl: int, x, b, x_zero: bool):
    L = cache.levels[lvl]
    x, bc = fused_down_reference(L, x, b, x_zero=x_zero)
    if lvl == len(cache.levels) - 1:
        xc = cache.Mc @ bc
    else:
        xc = _tail_go(cache, lvl + 1, torch.zeros_like(bc), bc, True)
    return fused_up_reference(L, x, b, xc)


def fused_tail_reference(cache: FusedTailCache, x, b, x_zero: bool = False):
    """One V-cycle over the whole tail in plain PyTorch: the recursion of
    the plain legs with x_c = Mc·b_c at the bottom."""
    return _tail_go(cache, 0, x, b, x_zero)


def fused_tail(cache: FusedTailCache, x, b, x_zero: bool = False):
    """x ← one V-cycle over the whole tail; ``x_zero`` asserts x is the zero
    vector (the tail is entered from a coarser-level recursion), so x is not
    read.  Returns x at ``x``'s (padded) length."""
    if x.device.type == "cpu":
        return fused_tail_reference(cache, x, b, x_zero=x_zero)
    if x.device.type != "cuda":
        raise ValueError(f"fused_tail runs on cuda or cpu tensors, not {x.device}")
    L0 = cache.levels[0]
    n = L0.row_dims[0] * L0.row_dims[1]
    check_vector("x", x, L0.A, n, L0.dtype)
    check_vector("b", b, L0.A, n, L0.dtype)
    suffixes = {plane_suffix(L, "fused_tail", dinv_working=True) for L in cache.levels}
    if len(suffixes) != 1 or cache.Mc.dtype != L0.dtype:
        raise TypeError(f"fused_tail: the levels' planes {suffixes} and Mc {cache.Mc.dtype} differ")
    if cache.desc is None or cache.desc.device != x.device:
        raise ValueError("the tail cache was not built on this card")
    nf = not cache.factored
    if nf and (cache.transfers is None or cache.transfers.device != x.device):
        raise ValueError("the tail cache's R/P planes were not put on this card")
    lib = load_library()
    per, (b7, x7), _ = _work_layout(cache.levels)
    block_cells = lib.amg_tail_block_cells()
    n_grid = sum(1 for L in cache.levels if L.row_dims[0] * L.row_dims[1] > block_cells)
    work = torch.empty(cache.work_len, dtype=x.dtype, device=x.device)
    x_out = torch.empty_like(x)
    if x.shape[0] > n:
        x_out[n:].zero_()
    tables = (cache.desc.data_ptr(), cache.transfers.data_ptr()) if nf else (cache.desc.data_ptr(),)
    err = getattr(lib, f"amg_fused_tail_{'nf_' if nf else ''}{suffixes.pop()}")(
        *tables, len(cache.levels), n_grid, work.data_ptr(), x_out.data_ptr(),
        None if x_zero else x.data_ptr(), b.data_ptr(), cache.Mc.data_ptr(), cache.n7, b7, x7,
        cache.smem, torch.cuda.current_stream(x.device).cuda_stream,
    )
    raise_on(err, "fused_tail kernel")
    launches["tail_nf" if nf else "tail"] += 1
    return x_out
