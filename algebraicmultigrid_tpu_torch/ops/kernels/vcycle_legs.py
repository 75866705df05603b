"""Fused V-cycle legs (K1 down, K2 up, K3 updown) on Lat2D levels.

Port of the JAX package's ``ops/pallas/vcycle_kernels.py`` in its factored
form.  Structured SA stashes the tentative prolongator T (one offset, box-k)
and the smoothing scale S = ω·D̃⁻¹, so P = (I − diag(S)·A)·T and R = Pᵀ:

* **down** (K1): multicolor GS/SOR presmooth over the color-step list,
  r = b − A·x, and the restriction b_c = box_k-sum(T⊙(r − A·(S⊙r)));
* **up** (K2): Tup = T⊙upsample_k(x_c), x += Tup − S⊙(A·Tup), then the
  postsmooth color steps;
* **updown** (K3): up of one cycle then down of the next, across the cycle
  boundary, with the double step list ``steps2_list`` (the boundary
  duplicate collapsed at ω = 1); the fixed-cycle loop runs it once per
  cycle at the top level.

Each leg has a hand-written CUDA kernel (``csrc/vcycle_legs.cu``; K3 is one
launch of independent tiles, each the tile plus a halo in shared memory,
``csrc/leg_tile.cuh``; on a 5-point level with bf16 planes under float32
vectors, one block an SM walks the tiles with the next tile's box landing
by TMA, ``csrc/updown_stage.cuh``) and a plain PyTorch version beside it
(``fused_down_reference``, ``fused_up_reference``,
``fused_updown_reference``).  The port's CUDA sources (these legs, the
whole-tail kernel ``csrc/tail_kernel.cu`` and its non-factored entries
``csrc/tail_nf_kernel.cu``, the whole-subcycle kernel
``csrc/subcycle_kernel.cu``, the BSG SpMV ``csrc/bsg_spmv.cu``, the
natural-order GS sweep ``csrc/scan_gs.cu``, the whole-sweep kernels K5
``csrc/gs_sweep.cu`` and K7 ``csrc/sweep3d.cu``, and the slab stencil K8
``csrc/halo_stencil.cu``) build into one library
at first use — one ``nvcc`` process per source for ``sm_90a``, all started
together, then one link — loaded with ``ctypes``.  The wrappers take the
plain version only for tensors on the CPU; on a CUDA tensor they launch the
kernel or raise.  ``launches`` counts the kernel launches of every wrapper
of that library (``tail`` is the whole-tail kernel's, ``sub`` the
whole-subcycle kernel's, ``bsg`` the BSG SpMV's, ``scan_gs`` the natural-order sweep's, ``gs`` K5's, ``sweep3d``
K7's and ``halo`` K8's); ``level_launches`` counts the leg and whole-sweep
kernels' launches by level.

bf16 coefficient planes (``coef_dtype=torch.bfloat16``, the JAX
package's ``AMG_COEF_DTYPE=bfloat16``, under float32 or float64 vectors): a
cache's A, D⁻¹, T and S are computed at float32 and rounded to bf16 (round
to nearest even, as the JAX package's leg builder computes and rounds them
under either working dtype); x, b and the arithmetic stay at the working
dtype.  The kernels convert each coefficient to the vectors' type where
they load it (the ``*_f32_bf16`` and ``*_f64_bf16`` entries; bf16 widens to
float, and float to double, exactly); the plain versions upcast the planes
to the vectors' dtype at use.

The non-factored R/P-plane branches (the JAX kernels' ``else`` branches):
a level without the SA factored stash — SA with ``NoSymmetry()``, or a
hierarchy loaded by ``load_hierarchy`` — keeps its R planes (nR coarse
planes) and P planes (nP fine planes) in the cache, expanded as the JAX
leg builder expands them (bf16: at float32, then rounded), and its legs
restrict with b_c = Σ_q R_q ⊙ r[k·c + δ_q] and correct with
x += Σ_q P_q ⊙ x_c[⌊i/k⌋ + δ_q].  On the card (``amg_fused_down_nf_*``,
``amg_fused_up_nf_*``) a level with a planned tile (``plan_down_nf``,
``plan_up_nf``) runs each leg as one launch of independent tiles, as the
factored legs: A, D⁻¹ and b in registers, x over the box in shared memory,
the R and P planes read once where they are used; the down tile keeps r on
the tile plus the R offsets' spill (``nf_spill``) in shared memory, so its
halo is one reach and the spill more than the steps' erosion; the up tile
stages x_c over its box's coarse window (``nf_window``).  A level with no
tile runs them pass by pass (the color-step passes of the factored pass
route, a residual pass, then one pass of the R-plane sum; the P-plane sum,
then the color steps).  K3 takes factored levels only, as in the JAX
package.  ``route_launches`` counts K1's, K2's and K3's launches by route.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import os
import shutil
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..coloring import color_steps, steps2_list
from ..lattice_op import expand_planes

__all__ = [
    "FusedLegCache",
    "build_fused_leg_cache",
    "build_level_legs",
    "round_planes",
    "coef_dtype_of",
    "plane_suffix",
    "fused_down",
    "fused_up",
    "fused_updown",
    "fused_down_reference",
    "fused_up_reference",
    "fused_updown_reference",
    "restrict_planes_reference",
    "correct_planes_reference",
    "leg_halo",
    "plan_tile",
    "plan_updown",
    "plan_down",
    "plan_up",
    "plan_up_pipelined",
    "plan_updown_staged",
    "updown_stage_bytes",
    "plan_down_nf",
    "plan_up_nf",
    "nf_spill",
    "nf_tile_smem_bytes",
    "tile_smem_bytes",
    "with_tile_plans",
    "launches",
    "build_library",
    "load_library",
]

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
SOURCES = tuple(
    CSRC / f
    for f in (
        "vcycle_legs.cu", "tail_kernel.cu", "tail_nf_kernel.cu", "subcycle_kernel.cu", "bsg_spmv.cu", "scan_gs.cu",
        "gs_sweep.cu", "sweep3d.cu", "halo_stencil.cu",
    )
)
HEADERS = tuple(
    CSRC / f
    for f in ("stencil.cuh", "leg_tile.cuh", "updown_stage.cuh", "tail_levels.cuh", "sweep_tile.cuh", "sweep_march.cuh")
)
BUILD_DIR = PACKAGE_DIR / "_build"

# the kernels' fixed parameter-struct capacities (csrc/stencil.cuh)
MAX_OFFSETS = 32
MAX_COLOR_CELLS = 64
MAX_STEPS = 64
# The tiles (fine cells along x, y) the plans start from, each cut to the
# register box: K3's, K1's and K2's, chosen by kernel_variants.py; the
# stencil sizes whose coefficients the tiled legs keep in registers, and
# the side of the largest box (tile + 2 halo) their thread maps hold (the
# thread maps of csrc/vcycle_legs.cu and csrc/leg_tile.cuh).  Such a box's
# buffers take at most ~100 KB of a block's shared memory.
UPDOWN_TILE = (48, 48)
DOWN_TILE = (64, 64)
UP_TILE = (64, 64)
REG_OFFSETS = (5, 9)
REG_BOX = 64
# the stencil size of the pipelined K2 (a stage of the next tile's box in
# shared memory beside the current tile's buffers); an SM's shared memory
# for one block (227 KB of the H100's 228), and room in it for a kernel's
# static level descriptor
PIPE_OFFSETS = 5
SMEM_LIMIT = 232_448
DESC_BYTES = 1024
# the tiles of a level are a CUDA grid's second dimension
MAX_TILE_ROWS = 65_535

launches = {
    "down": 0, "up": 0, "updown": 0, "tail": 0, "sub": 0, "bsg": 0, "scan_gs": 0, "gs": 0, "sweep3d": 0, "halo": 0,
    # the non-factored R/P-plane entries of K1, K2 and K4
    "down_nf": 0, "up_nf": 0, "tail_nf": 0,
}
# the leg and whole-sweep kernels' launches by level: (counter, grid dims) -> count
level_launches = collections.Counter()
# K1's, K2's and K3's launches by route: (counter, "tiles" | "pipelined" | "staged" | "pass") -> count
route_launches = collections.Counter()


@dataclasses.dataclass(frozen=True)
class FusedLegCache:
    """Full-size coefficient planes of one level's legs, at the working
    dtype or in bf16 (``round_planes``): factored (T and S), or the R and P
    planes (T and S None)."""

    A: torch.Tensor      # [nA, Wx, Wy] stencil planes
    dinv: torch.Tensor   # [Wx, Wy] 1/diag, 0 where diag == 0
    T: Optional[torch.Tensor]  # [Wx, Wy] tentative prolongator (offset (0, 0))
    S: Optional[torch.Tensor]  # [Wx, Wy] ω·D̃⁻¹ smoothing scale
    offsA: Tuple[Tuple[int, int], ...]
    color_grid: Tuple[Tuple[int, ...], ...]
    n_colors: int
    k: int
    row_dims: Tuple[int, int]   # fine (Wx, Wy)
    col_dims: Tuple[int, int]   # coarse (Wxc, Wyc)
    omega: float
    iter: int
    forward: bool
    backward: bool
    # K3's tile, from plan_updown when the cache is built; None: the level
    # is past the tiled kernel's limits and its updown runs K2 then K1
    updown_tile: Optional[Tuple[int, int]] = None
    # K1's and K2's tiles (plan_down, plan_up; non-factored: plan_down_nf,
    # plan_up_nf); None: the leg runs pass by pass.  up_pipelined: K2's
    # tiles are walked with the next tile's box staged in shared memory
    # (plan_up_pipelined)
    down_tile: Optional[Tuple[int, int]] = None
    up_tile: Optional[Tuple[int, int]] = None
    up_pipelined: bool = False
    # K3's tiles are walked by one block an SM with the next tile's box
    # landing in shared memory by TMA (plan_updown_staged); plane_maps: the
    # planes' tensor maps for it, encoded when the cache is built on the card
    updown_staged: bool = False
    plane_maps: Optional[bytes] = dataclasses.field(default=None, compare=False, repr=False)
    # the vectors' dtype where it is not the planes' (bf16 planes,
    # ``round_planes``); None: the planes' own, float32 under bf16 planes
    vec_dtype: Optional[torch.dtype] = None
    # the non-factored R/P planes: R [nR, Wxc, Wyc], coarse (I, J) reading
    # fine (k·I + dx, k·J + dy); P [nP, Wx, Wy], fine (i, j) reading coarse
    # (⌊i/k⌋ + dx, ⌊j/k⌋ + dy)
    R: Optional[torch.Tensor] = None
    P: Optional[torch.Tensor] = None
    offsR: Tuple[Tuple[int, int], ...] = ()
    offsP: Tuple[Tuple[int, int], ...] = ()

    @property
    def factored(self) -> bool:
        """P = (I − diag(S)·A)·T with T and S planes; else R and P planes."""
        return self.T is not None

    @property
    def dtype(self) -> torch.dtype:
        """The working dtype of the vectors."""
        if self.vec_dtype is not None:
            return self.vec_dtype
        return torch.float32 if self.A.dtype == torch.bfloat16 else self.A.dtype

    @property
    def steps(self) -> Tuple[int, ...]:
        return color_steps(self.n_colors, self.iter, self.forward, self.backward, self.omega)

    @property
    def steps2(self) -> Tuple[int, ...]:
        return steps2_list(self.n_colors, self.iter, self.forward, self.backward, self.omega)

    @property
    def reach(self) -> int:
        return _reach(self.offsA)


def leg_halo(n_steps: int, reach: int, restriction: bool) -> int:
    """Cells of halo a tile of a leg needs (csrc/leg_tile.cuh): its steps
    erode ``reach`` cells each, and a restriction two reaches more."""
    return (n_steps + (2 if restriction else 0)) * reach


def tile_smem_bytes(tx: int, ty: int, halo: int, reach: int, itemsize: int) -> int:
    """Shared memory of one tile (csrc/leg_tile.cuh ``tile_smem_bytes``): x
    over the box, Tup over the box plus one reach or r and g over the tile
    plus one reach, and a color byte per box cell."""
    e = (tx + 2 * halo) * (ty + 2 * halo)
    up = (tx + 2 * halo + 2 * reach) * (ty + 2 * halo + 2 * reach)
    rg = 2 * (tx + 2 * reach) * (ty + 2 * reach)
    return (e + max(up, rg)) * itemsize + -(-e // 16) * 16


def plan_tile(row_dims, k: int, n_off: int, halo: int, want):
    """(tile_x, tile_y) for a leg in tiles on a ``row_dims`` level: ``want``
    cut so that the box (tile + 2·halo) fits ``REG_BOX`` cells a side,
    rounded down to multiples of k, no larger than the grid (rounded up to
    k); None for a stencil of other than 5 or 9 points, where no k × k tile
    fits the box, or where the tiles' rows exceed a CUDA grid dimension."""
    side = REG_BOX - 2 * halo
    if n_off not in REG_OFFSETS or side < k:
        return None
    tile = tuple(min(min(w, side) // k * k, -(-W // k) * k) for w, W in zip(want, row_dims))
    if -(-row_dims[0] // tile[0]) > MAX_TILE_ROWS:
        return None
    return tile


def _plan_leg(row_dims, k: int, offs, n_steps: int, restriction: bool, margin: int, want):
    """A leg's tile for ``n_steps`` color steps: None past 64 steps, else
    ``plan_tile`` for its halo plus ``margin`` reaches."""
    if not 1 <= n_steps <= MAX_STEPS:
        return None
    reach = _reach(offs)
    return plan_tile(row_dims, k, len(offs), leg_halo(n_steps, reach, restriction) + margin * reach, want)


def plan_updown(row_dims, k: int, offs, n_steps2: int):
    """K3's tile on a level, or None when the level is past the tiled
    kernel's limits (more than 64 steps in the double sweep, a stencil of
    other than 5 or 9 points, or no k × k tile whose box fits ``REG_BOX``):
    decided from the shapes, once, when the leg cache is built."""
    return _plan_leg(row_dims, k, offs, n_steps2, True, 0, UPDOWN_TILE)


def plan_down(row_dims, k: int, offs, n_steps: int):
    """K1's tile on a level, or None (the leg runs pass by pass): as
    ``plan_updown``, for the single step list, from ``DOWN_TILE``."""
    return _plan_leg(row_dims, k, offs, n_steps, True, 0, DOWN_TILE)


def plan_up(row_dims, k: int, offs, n_steps: int):
    """K2's tile on a level, or None: its box plus one reach (where Tup is
    formed) within the register box, from ``UP_TILE``."""
    return _plan_leg(row_dims, k, offs, n_steps, False, 1, UP_TILE)


def _reach(offs) -> int:
    return max((max(abs(dx), abs(dy)) for dx, dy in offs), default=0)


def offset_span(offs) -> Tuple[int, int, int, int]:
    """(lo0, hi0, lo1, hi1): the span of the offsets (and 0) along each
    axis (csrc/leg_tile.cuh ``offset_span``)."""
    xs = [0] + [dx for dx, _ in offs]
    ys = [0] + [dy for _, dy in offs]
    return min(xs), max(xs), min(ys), max(ys)


def nf_spill(offsR, k: int) -> int:
    """Cells of r a non-factored down tile needs beyond each face: its
    coarse cells (fine k·I … k·I + k − 1) read fine k·I + δ over the R
    offsets δ (csrc/leg_tile.cuh ``nf_spill``)."""
    lo0, hi0, lo1, hi1 = offset_span(offsR)
    return max(-lo0, -lo1, max(hi0, hi1) - (k - 1))


def nf_down_halo(n_steps: int, reach: int, spill: int) -> int:
    """A non-factored down tile's halo: the steps' erosion, one reach for
    r = b − A·x, and the R offsets' spill."""
    return (n_steps + 1) * reach + spill


def nf_window(E: int, k: int, lo: int, hi: int) -> int:
    """Coarse cells of x_c a non-factored up tile stages along an axis of
    ``E`` box cells: the box's coarse cells (at most ⌈E/k⌉ + 1) and the P
    offsets' span ``lo`` … ``hi``."""
    return -(-E // k) + 1 + hi - lo


def nf_tile_smem_bytes(down: bool, tile, n_steps: int, reach: int, offs, k: int, itemsize: int) -> int:
    """Shared memory of a non-factored tile (csrc/leg_tile.cuh
    ``nf_smem_bytes``): x over the box, r over the tile and the spill of
    the R offsets ``offs`` (down) or x_c over the coarse window of the P
    offsets ``offs`` (up), and a color byte per box cell."""
    tx, ty = tile
    if down:
        sp = nf_spill(offs, k)
        halo = nf_down_halo(n_steps, reach, sp)
        scratch = (tx + 2 * sp) * (ty + 2 * sp)
    else:
        halo = leg_halo(n_steps, reach, False)
        lo0, hi0, lo1, hi1 = offset_span(offs)
        scratch = nf_window(tx + 2 * halo, k, lo0, hi0) * nf_window(ty + 2 * halo, k, lo1, hi1)
    e = (tx + 2 * halo) * (ty + 2 * halo)
    return (e + scratch) * itemsize + -(-e // 16) * 16


def plan_down_nf(row_dims, k: int, offs, offsR, n_steps: int):
    """K1's tile on a non-factored level, or None (the leg runs pass by
    pass): ``plan_tile`` for the halo ``nf_down_halo`` (the R offsets
    ``offsR`` set its spill), from ``DOWN_TILE``; None past 64 steps."""
    if not 1 <= n_steps <= MAX_STEPS:
        return None
    halo = nf_down_halo(n_steps, _reach(offs), nf_spill(offsR, k))
    return plan_tile(row_dims, k, len(offs), halo, DOWN_TILE)


def plan_up_nf(row_dims, k: int, offs, n_steps: int):
    """K2's tile on a non-factored level, or None: its box within the
    register box (the P-plane sum reads x_c staged in shared memory, so no
    Tup area), from ``UP_TILE``."""
    return _plan_leg(row_dims, k, offs, n_steps, False, 0, UP_TILE)


def stage_bytes(box, n_off: int, reach: int, k: int, itemsize: int, coef_itemsize: Optional[int] = None) -> int:
    """Shared memory of the pipelined K2's stage (csrc/vcycle_legs.cu
    ``stage_bytes``, ``pair_stage``): b and x over the box and x_c over its
    coarse cells at ``itemsize``, the planes A, dinv and S over the box and
    T over the box plus one reach at ``coef_itemsize`` (default
    ``itemsize``), 2-byte planes in rows padded to an even length (and b, x
    with them); to 16 bytes."""
    c = coef_itemsize or itemsize
    E0, E1 = box
    U0, U1 = E0 + 2 * reach, E1 + 2 * reach
    E1s, U1s = ((E1 + 2) & ~1, (U1 + 2) & ~1) if c == 2 else (E1, U1)
    vectors = 2 * E0 * E1s + (U0 // k + 2) * (U1 // k + 2)
    planes = (n_off + 2) * E0 * E1s + U0 * U1s
    return -(-(vectors * itemsize + planes * c) // 16) * 16


def _pairs_ok(cache: "FusedLegCache") -> bool:
    """2-byte planes stage a pair of coefficients a 4-byte copy: an even
    row length and 4-byte aligned planes (a factored cache's)."""
    ptrs = (cache.A.data_ptr(), cache.dinv.data_ptr(), cache.T.data_ptr(), cache.S.data_ptr())
    return cache.row_dims[1] % 2 == 0 and all(p % 4 == 0 for p in ptrs)


def plan_up_pipelined(cache: "FusedLegCache") -> bool:
    """Whether a level's tiled K2 runs pipelined: a 5-point level whose
    stage and tile buffers fit a block's shared memory (float32 at the
    flagship's L0, and float64 vectors with bf16 planes; not float64 with
    float64 planes), with 2-byte planes also an even Wy."""
    if len(cache.offsA) != PIPE_OFFSETS or cache.up_tile is None:
        return False
    size, coef = cache.dtype.itemsize, cache.A.element_size()
    if coef == 2 and not _pairs_ok(cache):
        return False
    r, h = cache.reach, leg_halo(len(cache.steps), cache.reach, False)
    tile = cache.up_tile
    box = (tile[0] + 2 * h, tile[1] + 2 * h)
    need = stage_bytes(box, PIPE_OFFSETS, r, cache.k, size, coef) + tile_smem_bytes(*tile, h, r, size)
    return need <= SMEM_LIMIT - DESC_BYTES


# a staged K3's stage rows (csrc/updown_stage.cuh kStageRow): a tensor copy
# starts a row at a multiple of 16 bytes of the grid, so a row holds the
# box's (at most REG_BOX cells) from its first column rounded down to 8
# cells; and the bytes the kernel may skip to align the stage to a tensor
# copy's 128 (kStageAlign)
STAGE_ROW = REG_BOX + 8
STAGE_ALIGN = 128


def updown_stage_bytes(box, reach: int, k: int, coef_itemsize: int, itemsize: int) -> int:
    """Shared memory of a staged K3's stage (csrc/updown_stage.cuh
    ``updown_stage``): A (5 planes) and D⁻¹ over the box's rows at
    ``coef_itemsize``, b and x over them at ``itemsize``, x_c over the
    coarse cells under T's area, and two slots of S over the box's rows and
    T over the box plus one reach; rows of ``STAGE_ROW`` cells, each array
    to 128 bytes."""
    E0, E1 = box
    U0, U1 = E0 + 2 * reach, E1 + 2 * reach
    to128 = lambda v: -(-v // 128) * 128
    plane, vec = E0 * STAGE_ROW * coef_itemsize, E0 * STAGE_ROW * itemsize
    xc = ((U0 - 1) // k + 2) * ((U1 - 1) // k + 2) * itemsize
    off = 0
    for size in (5 * plane, plane, vec, vec, xc) + (plane, U0 * STAGE_ROW * coef_itemsize) * 2:
        off = to128(off + size)
    return off


def _staged_box(cache: "FusedLegCache"):
    h = leg_halo(len(cache.steps2), cache.reach, True)
    return tuple(t + 2 * h for t in cache.updown_tile), h


def plan_updown_staged(cache: "FusedLegCache") -> bool:
    """Whether a level's tiled K3 runs staged (csrc/updown_stage.cuh): a
    5-point level with a K3 tile, float32 vectors under bf16 planes, rows of
    a multiple of 16 bytes and the planes contiguous and 16-byte aligned
    (what a tensor map takes), the box plus one reach within the thread map
    (``REG_BOX`` cells a side), and the stage and tile buffers within a
    block's shared memory.  The flagship's L0 is such a level; float32
    planes (whose stage does not fit at its box), 9-point levels, float64
    vectors and ragged rows keep the tiled K3."""
    if not cache.factored or len(cache.offsA) != PIPE_OFFSETS or cache.updown_tile is None:
        return False
    if cache.dtype != torch.float32 or cache.A.dtype != torch.bfloat16 or cache.row_dims[1] % 8:
        return False
    planes = (cache.A, cache.dinv, cache.T, cache.S)
    if any(p.dtype != torch.bfloat16 or not p.is_contiguous() or p.data_ptr() % 16 for p in planes):
        return False
    box, h = _staged_box(cache)
    if max(box) + 2 * cache.reach > REG_BOX:
        return False
    need = STAGE_ALIGN + updown_stage_bytes(box, cache.reach, cache.k, 2, 4) + tile_smem_bytes(
        *cache.updown_tile, h, cache.reach, 4)
    return need <= SMEM_LIMIT - DESC_BYTES


def _plane_maps(cache: "FusedLegCache") -> bytes:
    """The tensor maps of a staged level's planes on the card (A, D⁻¹, S
    over the box's rows, T over the box plus one reach): 4 CUtensorMaps."""
    box, _ = _staged_box(cache)
    maps = ctypes.create_string_buffer(4 * 128)
    err = load_library().amg_updown_plane_maps(
        maps, *(p.data_ptr() for p in (cache.A, cache.dinv, cache.T, cache.S)), *cache.row_dims, box[0],
        cache.reach)
    raise_on(err, "encoding the staged fused_updown's tensor maps")
    return maps.raw


def with_tile_plans(cache: "FusedLegCache") -> "FusedLegCache":
    """The cache with K3's, K1's and K2's tiles planned from its shapes (K2
    pipelined, K3 staged where they can be); a non-factored cache gets K1's
    and K2's own (``plan_down_nf``, ``plan_up_nf``), no K3 and no
    pipelined K2.  A staged cache on the card has its planes' tensor maps
    encoded here (``plane_maps``)."""
    n = len(cache.steps)
    if not cache.factored:
        return dataclasses.replace(
            cache, updown_tile=None, up_pipelined=False, updown_staged=False, plane_maps=None,
            down_tile=plan_down_nf(cache.row_dims, cache.k, cache.offsA, cache.offsR, n),
            up_tile=plan_up_nf(cache.row_dims, cache.k, cache.offsA, n),
        )
    c = dataclasses.replace(
        cache,
        updown_tile=plan_updown(cache.row_dims, cache.k, cache.offsA, len(cache.steps2)),
        down_tile=plan_down(cache.row_dims, cache.k, cache.offsA, n),
        up_tile=plan_up(cache.row_dims, cache.k, cache.offsA, n),
    )
    c = dataclasses.replace(c, up_pipelined=plan_up_pipelined(c), updown_staged=plan_updown_staged(c))
    return dataclasses.replace(c, plane_maps=_plane_maps(c) if c.updown_staged and c.A.is_cuda else None)


def coef_dtype_of(coef_dtype, dtype) -> Optional[torch.dtype]:
    """The plane dtype a ``coef_dtype`` keyword asks for: None (or the
    working dtype) keeps the planes at ``dtype``; ``torch.bfloat16`` (or
    ``"bfloat16"``) asks for bf16 planes under float32 or float64 vectors,
    as the JAX package's ``AMG_COEF_DTYPE=bfloat16`` does under either.
    Raises for any other value or working dtype."""
    if isinstance(coef_dtype, str):
        coef_dtype = getattr(torch, coef_dtype, coef_dtype)
    if coef_dtype is None or coef_dtype == dtype:
        return None
    if coef_dtype != torch.bfloat16:
        raise ValueError(f"coef_dtype is None or torch.bfloat16, not {coef_dtype!r}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"bf16 coefficient planes go under float32 or float64 vectors, not {dtype}")
    return coef_dtype


def round_planes(
    cache: "FusedLegCache", coef_dtype, dinv: bool = True, dtype=None, restriction: bool = True,
) -> "FusedLegCache":
    """The cache with its A, T, S and P planes (D⁻¹ with ``dinv``, R with
    ``restriction``) rounded from their dtype to ``coef_dtype`` (round to
    nearest even), under vectors of ``dtype`` (default the cache's), the
    tiles planned again.  The legs round D⁻¹ and R too; the whole-tail
    cache keeps D⁻¹ and its R planes at the working dtype, as the JAX
    package's caches do."""
    def rnd(t, keep=False):
        return t if t is None or keep else t.to(coef_dtype)

    return with_tile_plans(dataclasses.replace(
        cache,
        A=rnd(cache.A),
        dinv=rnd(cache.dinv, not dinv),
        T=rnd(cache.T),
        S=rnd(cache.S),
        R=rnd(cache.R, not restriction),
        P=rnd(cache.P),
        vec_dtype=dtype or cache.dtype,
    ))


def _factored_ok(specT, k, dims, cdims) -> bool:
    return (
        specT.base_x == (1, k)
        and specT.base_y == (1, k)
        and tuple(specT.row_dims) == dims
        and tuple(specT.col_dims) == cdims
        and any(tuple(o) == (0, 0) for o in specT.offsets)
        and all(
            tuple(o) == (0, 0) or not np.any(specT.table[i])
            for i, o in enumerate(specT.offsets)
        )
    )


def build_fused_leg_cache(
    specA, specR, specP, color_grid, n_colors: int, dtype, device,
    omega: float, iters: int, fwd: bool, bwd: bool, factored_T, coef_dtype=None,
) -> Optional[FusedLegCache]:
    """Planes for the legs, from the same inputs as the JAX package's
    ``_maybe_build_fused_legs``: ``factored_T = (specT, scale)`` with
    ``scale`` either ``("table", table, (Kx, sx, Ky, sy))`` or ``("vector",
    v)`` gives the factored legs where T passes the JAX builder's check;
    ``factored_T=None`` (or a T it refuses) the R and P planes.  None when
    the level is not a box-k level the kernels take (the cycle then runs the
    unfused path).  The planes are computed at ``dtype``; with
    ``coef_dtype=torch.bfloat16`` they are computed at float32 under either
    working dtype and rounded to bf16 (``round_planes``), as the JAX
    package's leg builder does."""
    coef_dtype = coef_dtype_of(coef_dtype, dtype)
    vec_dtype, dtype = dtype, (dtype if coef_dtype is None else torch.float32)
    if tuple(specA.base_x) != (1, 1) or tuple(specA.base_y) != (1, 1):
        return None
    kx, ky = tuple(specR.base_x), tuple(specR.base_y)
    if kx != ky or kx[1] != 1 or kx[0] not in (2, 3):
        return None
    k = kx[0]
    if tuple(specP.base_x) != (1, k) or tuple(specP.base_y) != (1, k):
        return None
    dims = tuple(specA.row_dims)
    cdims = tuple(specR.row_dims)
    if tuple(specP.row_dims) != dims or tuple(specP.col_dims) != cdims:
        return None
    grid = np.asarray(color_grid, dtype=np.int64)
    if len(specA.offsets) > MAX_OFFSETS or grid.size > MAX_COLOR_CELLS:
        return None
    specT, scale = factored_T if factored_T is not None else (None, None)
    factored = specT is not None and scale is not None and _factored_ok(specT, k, dims, cdims)
    if not factored and max(len(specR.offsets), len(specP.offsets)) > MAX_OFFSETS:
        return None

    Wx, Wy = dims
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    A = expand_planes(specA, dtype, device)
    offsA = tuple(tuple(int(v) for v in o) for o in specA.offsets)
    if (0, 0) in offsA:
        diag = A[offsA.index((0, 0))]
        dinv = torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, 1.0), 0.0)
    else:
        dinv = torch.zeros((Wx, Wy), dtype=dtype, device=device)
    meta = dict(
        offsA=offsA,
        color_grid=tuple(tuple(int(c) for c in row) for row in grid),
        n_colors=int(n_colors),
        k=k,
        row_dims=dims,
        col_dims=cdims,
        omega=float(omega),
        iter=int(iters),
        forward=bool(fwd),
        backward=bool(bwd),
    )
    if not factored:
        cache = with_tile_plans(FusedLegCache(
            A=A, dinv=dinv.contiguous(), T=None, S=None,
            R=expand_planes(specR, dtype, device), P=expand_planes(specP, dtype, device),
            offsR=tuple(tuple(int(v) for v in o) for o in specR.offsets),
            offsP=tuple(tuple(int(v) for v in o) for o in specP.offsets),
            **meta,
        ))
        return cache if coef_dtype is None else round_planes(cache, coef_dtype, dtype=vec_dtype)
    idxT = [tuple(o) for o in specT.offsets].index((0, 0))
    cxT, cyT = specT.row_class_arrays()
    T = torch.as_tensor(np.asarray(specT.table[idxT], dtype=np_dtype), device=device)
    T = T[torch.as_tensor(cxT, device=device)][:, torch.as_tensor(cyT, device=device)]
    if scale[0] == "table":
        from ...models.lattice import axis_classes

        _, tbl, (KxS, sxS, KyS, syS) = scale
        cxS = axis_classes(np.arange(Wx), Wx, KxS, sxS)
        cyS = axis_classes(np.arange(Wy), Wy, KyS, syS)
        S = torch.as_tensor(np.asarray(tbl, dtype=np_dtype), device=device)
        S = S[torch.as_tensor(cxS, device=device)][:, torch.as_tensor(cyS, device=device)]
    else:
        S = torch.as_tensor(np.asarray(scale[1], dtype=np_dtype).reshape(Wx, Wy), device=device)
    cache = with_tile_plans(FusedLegCache(A=A, dinv=dinv.contiguous(), T=T.contiguous(), S=S.contiguous(), **meta))
    return cache if coef_dtype is None else round_planes(cache, coef_dtype, dtype=vec_dtype)


def build_level_legs(level, dtype, device, coef_dtype=None) -> Optional[FusedLegCache]:
    """Fused legs for a host hierarchy level, wired as the JAX package's
    ``_maybe_build_fused_legs``: Lat2D A/P/R with box-k ratios, equal
    symmetric multicolor GS/SOR pre/post configs and a periodic coloring;
    factored where the SA setup stashed the factored prolongator, else on
    the R and P planes.  None → the level runs unfused."""
    from ...config import SOR, GaussSeidel, SymmetricSweep
    from ...models.lattice import LatticeMatrix, lattice_coloring

    cfg = level.presmoother_config
    if cfg != level.postsmoother_config:
        return None
    if not (isinstance(cfg, (GaussSeidel, SOR)) and cfg.ordering == "multicolor"):
        return None
    if not isinstance(cfg.sweep, SymmetricSweep):
        return None
    if not all(isinstance(M, LatticeMatrix) for M in (level.A, level.P, level.R)):
        return None
    got = lattice_coloring(level.A.spec)
    if got is None:
        return None
    grid, n_colors = got
    factored_T = None
    T_t = getattr(level, "T_tent", None)
    s_t = getattr(level, "psmooth_scale", None)
    if isinstance(T_t, LatticeMatrix) and s_t is not None:
        if isinstance(s_t, tuple) and s_t and s_t[0] == "table":
            factored_T = (T_t.spec, s_t)
        else:
            v = np.asarray(s_t).ravel()
            # the JAX builder takes the vector as it is and fails on a
            # wrong length; here that level keeps its R and P planes
            if v.shape[0] == level.A.spec.row_dims[0] * level.A.spec.row_dims[1]:
                factored_T = (T_t.spec, ("vector", v))
    omega = float(cfg.omega) if isinstance(cfg, SOR) else 1.0
    return build_fused_leg_cache(
        level.A.spec, level.R.spec, level.P.spec, grid, n_colors, dtype, device,
        omega, cfg.iter, True, True, factored_T, coef_dtype=coef_dtype,
    )


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------


def _stencil(A: torch.Tensor, X: torch.Tensor, offs) -> torch.Tensor:
    """Σₖ A_k ⊙ X[· + offₖ] with zeros outside the grid."""
    Wx, Wy = X.shape
    m = max((max(abs(dx), abs(dy)) for dx, dy in offs), default=0)
    Xp = torch.nn.functional.pad(X, (m, m, m, m))
    acc = None
    for kk, (dx, dy) in enumerate(offs):
        term = A[kk] * Xp[m + dx : m + dx + Wx, m + dy : m + dy + Wy]
        acc = term if acc is None else acc + term
    return acc


def _color_plane(cache: FusedLegCache, device) -> torch.Tensor:
    grid = torch.as_tensor(cache.color_grid, device=device)
    a, b = grid.shape
    Wx, Wy = cache.row_dims
    ix = torch.arange(Wx, device=device) % a
    iy = torch.arange(Wy, device=device) % b
    return grid[ix][:, iy]


def _planes(cache: FusedLegCache, dtype):
    """(A, dinv, T, S) at the vectors' dtype (T and S None on a non-factored
    cache): bf16 planes upcast at use, exactly, as the JAX kernels do once a
    bf16 plane meets an f32 vector."""
    return tuple(None if p is None else p.to(dtype) for p in (cache.A, cache.dinv, cache.T, cache.S))


def _sweep(cache: FusedLegCache, X, B, steps):
    col = _color_plane(cache, X.device)
    A, dinv, _, _ = _planes(cache, X.dtype)
    for c in steps:
        r = B - _stencil(A, X, cache.offsA)
        X = torch.where(col == c, X + cache.omega * dinv * r, X)
    return X


def _pad_out(X: torch.Tensor, length: int) -> torch.Tensor:
    v = X.reshape(-1)
    return torch.nn.functional.pad(v, (0, length - v.shape[0])) if length > v.shape[0] else v


def _margins(offs, n_src: int, n_dst: int) -> Tuple[int, int]:
    """(lo, hi) zero padding of a source axis of ``n_src`` cells so that
    ``d + i`` over a span of ``n_dst`` cells stays inside it for every
    offset d."""
    return max([0] + [-d for d in offs]), max([0] + [d + n_dst - n_src for d in offs])


def restrict_planes_reference(R: torch.Tensor, offsR, r: torch.Tensor, k: int, col_dims):
    """b_c[I, J] = Σ_q R_q[I, J] · r[k·I + dx_q, k·J + dy_q], r zero outside
    its grid (the JAX down kernel's residue-subsample sum), as a [Wxc, Wyc]
    grid; the terms summed in offset order."""
    Wx, Wy = r.shape
    Wxc, Wyc = col_dims
    span = lambda W: k * (W - 1) + 1
    lx, hx = _margins([d for d, _ in offsR], Wx, span(Wxc))
    ly, hy = _margins([d for _, d in offsR], Wy, span(Wyc))
    rp = torch.nn.functional.pad(r, (ly, hy, lx, hx))
    acc = None
    for q, (dx, dy) in enumerate(offsR):
        sub = rp[lx + dx : lx + dx + span(Wxc) : k, ly + dy : ly + dy + span(Wyc) : k]
        term = R[q] * sub
        acc = term if acc is None else acc + term
    return acc


def correct_planes_reference(P: torch.Tensor, offsP, xc: torch.Tensor, k: int, row_dims):
    """Σ_q P_q[i, j] · x_c[⌊i/k⌋ + dx_q, ⌊j/k⌋ + dy_q], x_c zero outside its
    grid (the JAX up kernel's shifted slices of the k-fold upsampled x_c), as
    a [Wx, Wy] grid; the terms summed in offset order."""
    Wx, Wy = row_dims
    Wxc, Wyc = xc.shape
    lx, hx = _margins([d for d, _ in offsP], Wxc, -(-Wx // k))
    ly, hy = _margins([d for _, d in offsP], Wyc, -(-Wy // k))
    up = torch.nn.functional.pad(xc, (ly, hy, lx, hx)).repeat_interleave(k, dim=0).repeat_interleave(k, dim=1)
    acc = None
    for q, (dx, dy) in enumerate(offsP):
        src = up[k * (lx + dx) : k * (lx + dx) + Wx, k * (ly + dy) : k * (ly + dy) + Wy]
        term = P[q] * src
        acc = term if acc is None else acc + term
    return acc


def _restrict(cache: FusedLegCache, X, B):
    """r = B − A·X restricted, flat [Wxc·Wyc]: b_c = box_k-sum(T⊙(r −
    A·(S⊙r))) on a factored cache, else the R-plane sum."""
    Wx, Wy = cache.row_dims
    Wxc, Wyc = cache.col_dims
    k = cache.k
    A, _, T, S = _planes(cache, X.dtype)
    r = B - _stencil(A, X, cache.offsA)
    if not cache.factored:
        return restrict_planes_reference(cache.R.to(X.dtype), cache.offsR, r, k, cache.col_dims).reshape(Wxc * Wyc)
    ts = T * (r - _stencil(A, S * r, cache.offsA))
    ts = torch.nn.functional.pad(ts, (0, k * Wyc - Wy, 0, k * Wxc - Wx))
    return ts.reshape(Wxc, k, Wyc, k).sum(dim=1).sum(dim=2).reshape(Wxc * Wyc)


def _correct(cache: FusedLegCache, X, xc):
    """X + P·x_c: P = (I − diag(S)·A)·T on a factored cache, else the
    P-plane sum."""
    Wx, Wy = cache.row_dims
    Wxc, Wyc = cache.col_dims
    k = cache.k
    XC = xc[: Wxc * Wyc].reshape(Wxc, Wyc)
    if not cache.factored:
        return X + correct_planes_reference(cache.P.to(X.dtype), cache.offsP, XC, k, cache.row_dims)
    up = XC.repeat_interleave(k, dim=0).repeat_interleave(k, dim=1)[:Wx, :Wy]
    A, _, T, S = _planes(cache, X.dtype)
    Tup = T * up
    return X + (Tup - S * _stencil(A, Tup, cache.offsA))


def fused_down_reference(cache: FusedLegCache, x, b, x_zero: bool = False):
    """(x', b_c) = (presmooth(x, b), R·(b − A·x')) in plain PyTorch."""
    Wx, Wy = cache.row_dims
    n = Wx * Wy
    B = b[:n].reshape(Wx, Wy)
    X = torch.zeros_like(B) if x_zero else x[:n].reshape(Wx, Wy)
    X = _sweep(cache, X, B, cache.steps)
    return _pad_out(X, x.shape[0]), _restrict(cache, X, B)


def fused_up_reference(cache: FusedLegCache, x, b, xc):
    """x = postsmooth(x + P·x_c, b) in plain PyTorch."""
    Wx, Wy = cache.row_dims
    n = Wx * Wy
    B = b[:n].reshape(Wx, Wy)
    X = _correct(cache, x[:n].reshape(Wx, Wy), xc)
    X = _sweep(cache, X, B, cache.steps)
    return _pad_out(X, x.shape[0])


def _factored_only(cache: FusedLegCache):
    """K3 takes factored levels only, as the JAX ``fused_updown`` does."""
    if not cache.factored:
        raise ValueError("fused_updown takes a factored leg cache (T and S planes), not the R/P planes")


def fused_updown_reference(cache: FusedLegCache, x, b, xc):
    """(x', b_c') = down(up(x, x_c)) across the cycle boundary, with the
    double step list, in plain PyTorch."""
    _factored_only(cache)
    Wx, Wy = cache.row_dims
    n = Wx * Wy
    B = b[:n].reshape(Wx, Wy)
    X = _correct(cache, x[:n].reshape(Wx, Wy), xc)
    X = _sweep(cache, X, B, cache.steps2)
    return _pad_out(X, x.shape[0]), _restrict(cache, X, B)


# --------------------------------------------------------------------------
# CUDA build and binding
# --------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path() -> Path:
    """Build output, named by a content hash of every source and header so
    an edited source never loads a stale build."""
    h = hashlib.sha256()
    for f in SOURCES + HEADERS:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libamg_kernels-{h.hexdigest()[:16]}.so"


_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]


def compile_command(src: Path, obj: Path) -> list:
    return [_nvcc(), *_NVCC_FLAGS, "-c", str(src), "-o", str(obj)]


def link_command(objs, out: Path) -> list:
    return [_nvcc(), *_NVCC_FLAGS, "-shared", "-o", str(out), *(str(o) for o in objs)]


def build_library(out: Path, sources=SOURCES) -> None:
    """Compile every source in its own nvcc process, all started together,
    and link the objects into ``out`` (written atomically)."""
    import subprocess

    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{Path(src).stem}-{tag}.o" for src in sources]
    procs = [subprocess.Popen(compile_command(src, obj)) for src, obj in zip(sources, objs)]
    failed = [Path(src).name for src, p in zip(sources, procs) if p.wait()]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(link_command(objs, tmp), check=True)
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)


_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
_D = ctypes.c_double
_STENCIL = [_IP, _I, _IP, _I, _I, _IP, _I, _D]  # offs, n_off, colors a x b, steps, omega
# the whole-sweep entries after their five pointers: dims, offs, n_off, periods, color table, steps,
# n_steps, plan (box or march), pad, omega, stream
_SWEEP = [_IP, _IP, _I, _IP, _IP, _IP, _I, _IP, _I, _D, _P]
_SIGNATURES = {
    "amg_fused_down_{}": [_P] * 10 + _STENCIL + [_I] * 7 + [_P],
    "amg_fused_up_{}": [_P] * 8 + _STENCIL + [_I] * 8 + [_P],
    "amg_fused_updown_{}": [_P] * 9 + _STENCIL + [_I] * 7 + [_P],
    "amg_fused_tail_{}": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _L, _L, _I, _P],
    "amg_fused_down_nf_{}": [_P] * 8 + _STENCIL + [_IP, _I] + [_I] * 7 + [_P],
    "amg_fused_up_nf_{}": [_P] * 7 + _STENCIL + [_IP, _I] + [_I] * 7 + [_P],
    "amg_fused_tail_nf_{}": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _L, _L, _I, _P],
    "amg_fused_subcycle_{}": [_P, _I, _I, _P, _P, _P, _P, _I, _L, _L, _I, _P],
    "amg_scan_gs_{}": [_P] * 9 + [_I, _I, _I, _D, _I, _I, _I, _I, _P],
    "amg_gs_sweep_{}": [_P] * 5 + _SWEEP,
    "amg_gs_sweep_march_{}": [_P] * 5 + _SWEEP,
    "amg_sweep3d_{}": [_P] * 5 + _SWEEP,
    "amg_sweep3d_march_{}": [_P] * 5 + _SWEEP,
    "amg_halo_stencil_{}": [_P, _P, _L, _P, _P, _IP] + [_I] * 5 + [_P],
}


# the entries with bf16 coefficient planes, by the vectors' type
_BF16_ENTRIES = {
    "amg_fused_down_{}": ("f32_bf16", "f64_bf16"), "amg_fused_up_{}": ("f32_bf16", "f64_bf16"),
    "amg_fused_updown_{}": ("f32_bf16", "f64_bf16"), "amg_fused_tail_{}": ("f32_bf16", "f64_bf16"),
    "amg_fused_down_nf_{}": ("f32_bf16", "f64_bf16"), "amg_fused_up_nf_{}": ("f32_bf16", "f64_bf16"),
    "amg_fused_tail_nf_{}": ("f32_bf16", "f64_bf16"), "amg_fused_subcycle_{}": ("f32_bf16", "f64_bf16"),
    "amg_sweep3d_march_{}": ("f32_bf16",),
}


# the library's other entries (all return int)
_HELPERS = {
    "amg_tail_level_bytes": [],
    "amg_tail_block_cells": [],
    "amg_tile_smem_bytes": [_I] * 5,
    "amg_nf_tile_smem_bytes": [_I] * 5 + [_IP] + [_I] * 3,
    "amg_tail_fill_level": [_P, _I, _P, _P, _P, _P, _L, _L, _L, _L, _L] + [_I] * 7 + _STENCIL,
    "amg_tail_transfer_bytes": [],
    "amg_tail_fill_transfer": [_P, _I, _P, _P, _IP, _I, _IP, _I, _I, _I],
    "amg_scan_gs_smem_bytes": [_I] * 5,
    "amg_sweep3d_march_smem_bytes": [_I] * 5,
    "amg_gs_sweep_march_smem_bytes": [_I] * 6,
    "amg_gs_sweep_march_batch": [_I],
    "amg_gs_sweep_march_blocks_per_sm": [_I] * 4,
    "amg_sweep3d_march_blocks_per_sm": [_I] * 6,
    "amg_bsg_spmv_f32": [_P] * 5 + [_L, _I, _I, _L, _P],
    # the staged K3 (float32 vectors, bf16 planes), its planes' tensor maps and its stage's bytes
    "amg_fused_updown_staged_f32_bf16": [_P] * 10 + _STENCIL + [_I] * 7 + [_P],
    "amg_updown_plane_maps": [_P] * 5 + [_I] * 4,
    "amg_updown_stage_bytes": [_I] * 6,
}


def load_library():
    """Build (at first use) and load the port's CUDA library: the legs, the
    whole-tail and whole-subcycle kernels, the BSG SpMV, the natural-order GS sweep, the
    whole-sweep kernels K5 and K7 and the slab stencil K8."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        build_library(out)
    lib = ctypes.CDLL(str(out))
    for name, args in _SIGNATURES.items():
        for sfx in ("f32", "f64") + _BF16_ENTRIES.get(name, ()):
            fn = getattr(lib, name.format(sfx))
            fn.argtypes, fn.restype = args, _I
    for name, args in _HELPERS.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, _I
    _lib = lib
    return lib


def _ints(vals):
    vals = [int(v) for v in vals]
    return (ctypes.c_int * max(len(vals), 1))(*vals)


SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# (vectors, planes) -> the C entry suffix, for bf16 planes
BF16_SUFFIX = {torch.float32: "f32_bf16", torch.float64: "f64_bf16"}


def check_vector(name: str, t: torch.Tensor, like: torch.Tensor, min_len: int, dtype=None):
    """Raise unless ``t`` is a contiguous flat vector of at least ``min_len``
    on ``like``'s device with ``dtype`` (default ``like``'s dtype)."""
    dtype = like.dtype if dtype is None else dtype
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, the level's planes on {like.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the level's vectors {dtype}")
    if t.dim() != 1 or t.shape[0] < min_len:
        raise ValueError(f"{name} must be a flat vector of length >= {min_len}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stencil_args(cache: FusedLegCache, steps):
    """(offs, n_off, color table, a, b, steps, n_steps, omega) as the C entry
    points take them."""
    offs = _ints([v for o in cache.offsA for v in o])
    grid = np.asarray(cache.color_grid)
    return (
        offs, len(cache.offsA), _ints(grid.ravel()), grid.shape[0], grid.shape[1],
        _ints(steps), len(steps), cache.omega,
    )


def plane_suffix(cache: FusedLegCache, name: str, dinv_working: bool = False) -> str:
    """The C entry suffix of a cache's (vector, plane) dtypes: "f32",
    "f64", or "f32_bf16" / "f64_bf16" for bf16 A, T and S, or A, R and P
    (and D⁻¹, or D⁻¹ and R at the vectors' dtype with ``dinv_working``, the
    whole-tail cache's); raises for a pair with no entry."""
    vec, coef = cache.dtype, cache.A.dtype
    want_dinv = vec if dinv_working else coef
    if cache.factored:
        want = {"T": (cache.T, coef), "S": (cache.S, coef)}
    else:
        want = {"R": (cache.R, want_dinv), "P": (cache.P, coef)}
    want["D⁻¹"] = (cache.dinv, want_dinv)
    bad = {k: (t.dtype, d) for k, (t, d) in want.items() if t.dtype != d}
    if bad:
        raise TypeError(
            f"{name}: planes A {coef} and " + ", ".join(f"{k} {g} (must be {d})" for k, (g, d) in bad.items())
            + " have no entry"
        )
    if coef == vec and vec in SUFFIX:
        return SUFFIX[vec]
    if coef == torch.bfloat16 and vec in BF16_SUFFIX:
        return BF16_SUFFIX[vec]
    raise TypeError(f"{name} takes float32 or float64 planes, or bf16 planes under either, not {coef}"
                    f" under {vec}")


def raise_on(err: int, what: str):
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _prepare(cache: FusedLegCache, name: str, x, vecs):
    """Check a CUDA call's vectors; returns (library entry point, x_out)
    with x_out at x's (padded) length, zero beyond the level."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {x.device}")
    for vname, t, n in vecs:
        check_vector(vname, t, cache.A, n, cache.dtype)
    fn = getattr(load_library(), f"amg_{name}_{plane_suffix(cache, name)}")
    x_out = torch.empty_like(x)
    n = cache.row_dims[0] * cache.row_dims[1]
    if x.shape[0] > n:
        x_out[n:].zero_()
    return fn, x_out


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _tile_args(cache: FusedLegCache, tile, name: str):
    """(tile_x, tile_y) for a leg's C entry point: its planned tile, or
    (0, 0) for the pass-by-pass route."""
    if tile is None:
        return 0, 0
    if cache.row_dims[0] * cache.row_dims[1] >= 2**31:
        raise ValueError(f"{name} indexes a tiled level's cells in 32 bits")
    return tile


def _offsets(offs):
    """(offsets, count) as a C entry takes a stencil."""
    return _ints([v for o in offs for v in o]), len(offs)


def _count(name: str, cache: FusedLegCache, route: str):
    launches[name] += 1
    level_launches[name, cache.row_dims] += 1
    route_launches[name, route] += 1


def _fused_down_nf(cache: FusedLegCache, x, b, x_zero: bool):
    """K1's non-factored entry: one launch of tiles on a level with a
    planned tile (``cache.down_tile``), else the presmooth passes, a
    residual pass into r and the R-plane restriction pass."""
    Wx, Wy = cache.row_dims
    Wxc, Wyc = cache.col_dims
    n = Wx * Wy
    tile = _tile_args(cache, cache.down_tile, "fused_down_nf")
    fn, x_out = _prepare(cache, "fused_down_nf", x, [("x", x, n), ("b", b, n)])
    # the r plane only for the pass-by-pass route
    r = None if cache.down_tile is not None else torch.empty((Wx, Wy), dtype=x.dtype, device=x.device)
    bc = torch.empty(Wxc * Wyc, dtype=x.dtype, device=x.device)
    err = fn(
        x_out.data_ptr(), None if x_zero else x.data_ptr(), b.data_ptr(),
        cache.A.data_ptr(), cache.dinv.data_ptr(), cache.R.data_ptr(), None if r is None else r.data_ptr(),
        bc.data_ptr(), *stencil_args(cache, cache.steps), *_offsets(cache.offsR), Wx, Wy, Wxc, Wyc, cache.k, *tile,
        _stream(x),
    )
    raise_on(err, "fused_down_nf kernel")
    _count("down_nf", cache, "pass" if r is not None else "tiles")
    return x_out, bc


def _fused_up_nf(cache: FusedLegCache, x, b, xc):
    """K2's non-factored entry: one launch of tiles on a level with a
    planned tile (``cache.up_tile``), else the P-plane correction pass,
    then the postsmooth passes."""
    Wx, Wy = cache.row_dims
    Wxc, Wyc = cache.col_dims
    n = Wx * Wy
    tile = _tile_args(cache, cache.up_tile, "fused_up_nf")
    fn, x_out = _prepare(cache, "fused_up_nf", x, [("x", x, n), ("b", b, n), ("xc", xc, Wxc * Wyc)])
    err = fn(
        x_out.data_ptr(), x.data_ptr(), b.data_ptr(), cache.A.data_ptr(), cache.dinv.data_ptr(),
        cache.P.data_ptr(), xc.data_ptr(), *stencil_args(cache, cache.steps), *_offsets(cache.offsP),
        Wx, Wy, Wxc, Wyc, cache.k, *tile, _stream(x),
    )
    raise_on(err, "fused_up_nf kernel")
    _count("up_nf", cache, "pass" if cache.up_tile is None else "tiles")
    return x_out


def fused_down(cache: FusedLegCache, x, b, x_zero: bool = False):
    """(x', b_c) = (presmooth(x, b), R·(b − A·x')); ``x_zero`` asserts x is
    the zero vector (coarse-level cycles start from it), so x is not read.
    Returns x' at ``x``'s (padded) length and b_c at Wxc·Wyc.  A level with
    a planned tile (``cache.down_tile``) runs one launch of independent
    tiles; any other, pass by pass; a non-factored level its own entry, by
    the same rule."""
    if x.device.type == "cpu":
        return fused_down_reference(cache, x, b, x_zero=x_zero)
    if not cache.factored:
        return _fused_down_nf(cache, x, b, x_zero)
    Wx, Wy = cache.row_dims
    Wxc, Wyc = cache.col_dims
    n = Wx * Wy
    tile = _tile_args(cache, cache.down_tile, "fused_down")
    fn, x_out = _prepare(cache, "fused_down", x, [("x", x, n), ("b", b, n)])
    # r and g planes only for the pass-by-pass route
    rg = [None, None]
    if cache.down_tile is None:
        rg = [torch.empty((Wx, Wy), dtype=x.dtype, device=x.device) for _ in range(2)]
    bc = torch.empty(Wxc * Wyc, dtype=x.dtype, device=x.device)
    err = fn(
        x_out.data_ptr(), None if x_zero else x.data_ptr(), b.data_ptr(),
        cache.A.data_ptr(), cache.dinv.data_ptr(), cache.T.data_ptr(), cache.S.data_ptr(),
        *(None if t is None else t.data_ptr() for t in rg), bc.data_ptr(),
        *stencil_args(cache, cache.steps), Wx, Wy, Wxc, Wyc, cache.k, *tile, _stream(x),
    )
    raise_on(err, "fused_down kernel")
    _count("down", cache, "pass" if cache.down_tile is None else "tiles")
    return x_out, bc


def fused_up(cache: FusedLegCache, x, b, xc):
    """x = postsmooth(x + P·x_c, b); returns x at ``x``'s (padded) length.
    Tiled (``cache.up_tile``; pipelined where ``cache.up_pipelined``) or
    pass by pass, as ``fused_down`` (a non-factored level its own entry)."""
    if x.device.type == "cpu":
        return fused_up_reference(cache, x, b, xc)
    if not cache.factored:
        return _fused_up_nf(cache, x, b, xc)
    Wx, Wy = cache.row_dims
    Wxc, Wyc = cache.col_dims
    n = Wx * Wy
    tile = _tile_args(cache, cache.up_tile, "fused_up")
    fn, x_out = _prepare(cache, "fused_up", x, [("x", x, n), ("b", b, n), ("xc", xc, Wxc * Wyc)])
    err = fn(
        x_out.data_ptr(), x.data_ptr(), b.data_ptr(),
        cache.A.data_ptr(), cache.dinv.data_ptr(), cache.T.data_ptr(), cache.S.data_ptr(),
        xc.data_ptr(), *stencil_args(cache, cache.steps), Wx, Wy, Wxc, Wyc, cache.k, *tile,
        int(cache.up_pipelined), _stream(x),
    )
    raise_on(err, "fused_up kernel")
    route = "pass" if cache.up_tile is None else "pipelined" if cache.up_pipelined else "tiles"
    _count("up", cache, route)
    return x_out


def fused_updown(cache: FusedLegCache, x, b, xc):
    """(x', b_c') = down(up(x, x_c)) across the cycle boundary in one
    launch of tiles: returns the corrected and twice-smoothed x at ``x``'s
    (padded) length and the next cycle's coarse rhs at Wxc·Wyc.  A staged
    level (``cache.updown_staged``) walks its tiles one block an SM with the
    next tile's box landing by TMA, where x and b lie 16-byte aligned (a
    tensor map's base); any other, or unaligned vectors, one block a tile.
    A level with no planned tile (``cache.updown_tile`` None) has no K3 on
    the card; ``run_fixed_cycles`` runs K2 then K1 there.  Factored levels
    only, as in the JAX package."""
    _factored_only(cache)
    if x.device.type == "cpu":
        return fused_updown_reference(cache, x, b, xc)
    if cache.updown_tile is None:
        raise ValueError(f"level {cache.row_dims} is past the tiled updown kernel's limits: run K2 then K1")
    Wx, Wy = cache.row_dims
    Wxc, Wyc = cache.col_dims
    n = Wx * Wy
    if n >= 2**31:
        raise ValueError("fused_updown indexes a level's cells in 32 bits")
    fn, x_out = _prepare(cache, "fused_updown", x, [("x", x, n), ("b", b, n), ("xc", xc, Wxc * Wyc)])
    bc = torch.empty(Wxc * Wyc, dtype=x.dtype, device=x.device)
    args = [x_out.data_ptr(), x.data_ptr(), b.data_ptr(), cache.A.data_ptr(), cache.dinv.data_ptr(),
            cache.T.data_ptr(), cache.S.data_ptr(), xc.data_ptr(), bc.data_ptr()]
    staged = cache.updown_staged and x.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    if staged:
        fn = load_library().amg_fused_updown_staged_f32_bf16
        args.append(cache.plane_maps)
    err = fn(*args, *stencil_args(cache, cache.steps2), Wx, Wy, Wxc, Wyc, cache.k, *cache.updown_tile, _stream(x))
    raise_on(err, "fused_updown kernel")
    _count("updown", cache, "staged" if staged else "tiles")
    return x_out, bc
