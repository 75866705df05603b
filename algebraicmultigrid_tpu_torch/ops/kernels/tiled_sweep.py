"""What K5 (``gs_sweep.py``) and K7 (``sweep3d.py``) share: the cache, the
tile plan, the plain version and the launch.

Both compute one multicolor GS/SOR smoother application on a lattice
level: for each color c of ``color_steps(n_colors, iter, forward, backward,
omega)``, in order, the cells of color c take

    x ← x + ω·D⁻¹(b − A·x)

with x read as 0 outside the grid; the padding rows past the level pass
through unchanged.  Each application is one launch of the march
(``csrc/sweep_march.cuh``, ``plan_march``, the cache's ``march``), planned
when the cache is built: a block marches along axis 0 over a column of the
grid and a segment of planes, each plane's x landing once in a ring in
shared memory and the color steps running as a wavefront a reach behind
each other.

* K7, a 3-D level: the column is a y-z box (tile plus halo on axes 1, 2).
* K5, a Wx × Wy Lat2D level: the grid (Wx, 1, Wy) (``_as3``), a column is
  a 1 × E2 strip of the level's rows (``MARCH_STRIP``).

The march takes every level that the halo-tile kernel (``csrc/
sweep_tile.cuh``, ``plan_box``: a tile of x plus a halo of
``n_steps·reach`` cells per axis in shared memory), the first design of
both, takes; that one stays only as the march's comparison
(``tile_view``, ``gs_sweep.smooth_gs_tile``, ``sweep3d.smooth_sweep3d_tile``).

The launch path is packed once per cache (``TiledSweepCache.launch_args``:
the step list and the C entry point's argument arrays), the kernels raise
their shared-memory limit once per size, and the kernel itself copies x's
padding rows.

The plain version (``tiled_sweep_reference``) is the step-by-step masked
sweep: per step one full stencil pass and a masked blend, the arithmetic of
``models/device.py::_smooth_masked_multicolor`` on the same operator, so
on the CPU the two agree bitwise.

A 3-D LatND level with bf16 planes under float32 vectors (``coef_dtype``)
runs K7's march entry ``amg_sweep3d_march_f32_bf16``, which converts each
coefficient to float where it loads it; D⁻¹, x and b stay float32 (the JAX
K7's).  The halo-tile kernel takes no bf16 planes (``tile_view`` raises).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..coloring import color_steps
from .vcycle_legs import (
    MAX_COLOR_CELLS, MAX_OFFSETS, SMEM_LIMIT, SUFFIX, _ints, _stream, check_vector, launches, level_launches,
    BF16_SUFFIX, load_library, raise_on,
)

__all__ = [
    "MarchPlan", "TiledSweepCache", "card_shape", "plan_box", "plan_march", "tile_view", "tiled_sweep_cache",
    "tiled_sweep_reference", "launch_tiled_sweep",
]

log = logging.getLogger(__name__)

MAX_STEPS = 64  # csrc/stencil.cuh kMaxSteps
# the offsets K5's march takes (its wide instance, csrc/sweep_march.cuh
# kMarchMaxOff: the structured Ruge-Stueben hierarchy's coarse Lat2D levels
# reach 37 and 45); K7's march and the halo-tile kernel take MAX_OFFSETS
MARCH_MAX_OFFSETS_2D = 64
# the halo-tile kernel's loaded box (tile + halo) per axis, chosen by
# kernel_variants.py sweeps: 3-D boxes of 14 x 14 x 64 cells (50 KB of
# float32, four blocks an SM), 2-D boxes of 32 x 64 cells
BOX = {2: (1, 32, 64), 3: (14, 14, 64)}
# no axis of a tile is cut below this many cells to make room for a halo
MIN_TILE = 8
# the grid's tile counts on axes 0 and 1 are CUDA grid dimensions
MAX_TILES = 65_535
# K7's march (csrc/sweep_march.cuh): the y-z box (tile + 2 halo on axes 1
# and 2) it starts from per itemsize, chosen by kernel_variants.py sweeps;
# the kernel's own constants: the planes a time step loads, steps and
# stores (kMarchBatch), the batches loaded ahead (kMarchDepth), the axis-2
# neighbours a thread updates (kMarchUnit) and the block's threads
MARCH_BOX = {4: (32, 64), 8: (32, 32)}
# K5's march on a Lat2D level: the strip's tile on the contiguous axis it
# starts from (the level's width cut into whole columns of about this many
# cells), chosen by kernel_variants.py sweeps march2d
MARCH_STRIP = 512
MARCH_BATCH = 4
# K5's batch by the level's offset count (csrc/gs_sweep.cu kGsBatch5/9:
# 2 rows on the 5-point level, 4 on the 9-point ones); MARCH_BATCH for others
MARCH_BATCH_2D = {5: 2, 9: 4}
MARCH_DEPTH = 1
MARCH_UNIT = 2
# the block's threads at most: K7's y-z boxes, K5's strips (csrc/gs_sweep.cu
# kGsMarchThreads: 128 registers a thread)
MARCH_MAX_THREADS = 1024
MARCH_MAX_THREADS_2D = 512
# (SMs, shared memory bytes and threads an SM) of the card the segment plan
# fills where the level is not on one: the H100 SXM the kernels are built
# for (sm_90a); and the shared memory the card reserves for each block
H100_SM = (132, 233_472, 2048)
SM_SMEM_RESERVE = 1024


@dataclasses.dataclass(frozen=True)
class MarchPlan:
    """The march on one level: the y-z box (a 1 × E2 strip on a Lat2D
    level) and the planes a segment owns; from them, x's ring depth in
    planes and the block's shared memory; the planes a time step takes (the
    kernel instance's batch)."""

    box: Tuple[int, int]
    seg: int
    ring: int
    smem: int
    batch: int = MARCH_BATCH

    def args(self) -> Tuple[int, ...]:
        """The plan as the C entry point takes it."""
        return (*self.box, self.seg)


@dataclasses.dataclass(frozen=True)
class TiledSweepCache:
    """One level's whole-sweep smoother.  ``A`` is the level's own Lat2D or
    LatND operator: the kernel reads its planes in place."""

    A: Any
    dinv: torch.Tensor                      # [rows_padded] 1/diag
    dims: Tuple[int, int, int]              # the grid: (Wx, 1, Wy) for 2-D (the march's view)
    offsets: Tuple[Tuple[int, int, int], ...]
    periods: Tuple[int, int, int]
    color_table: Tuple[int, ...]            # flat, C order over periods
    n_colors: int
    box: Optional[Tuple[int, int, int]]     # the halo-tile kernel's tile + 2·halo per axis
    omega: float
    iter: int
    forward: bool
    backward: bool
    nd: int                                 # 2 (K5) or 3 (K7)
    # the level's masked multicolor cache, which runs a multi-RHS x[n, k]
    # (the JAX package's ``fallback`` field); None where none was built
    fallback: Any = None
    march: Optional[MarchPlan] = None
    # packed at build (``__post_init__``): the color steps and the C entry
    # point's arguments from dims to the plan
    steps: Tuple[int, ...] = dataclasses.field(init=False, repr=False, compare=False)
    launch_args: Optional[tuple] = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        steps = color_steps(self.n_colors, self.iter, self.forward, self.backward, self.omega)
        plan = self.march.args() if self.march is not None else self.box
        args = None
        if plan is not None:
            args = (
                _ints(self.dims), _ints([v for d in self.offsets for v in d]), len(self.offsets),
                _ints(self.periods), _ints(self.color_table), _ints(steps), len(steps), _ints(plan),
            )
        object.__setattr__(self, "steps", steps)
        object.__setattr__(self, "launch_args", args)
        planes = self.A.data
        if planes.device.type == "cuda":
            check_vector("dinv", self.dinv, planes, math.prod(self.dims), self.A.dtype)

    @property
    def halo(self) -> Tuple[int, int, int]:
        n = len(self.steps)
        return tuple(n * max(abs(d[a]) for d in self.offsets) for a in range(3))


def _as3(dims, offsets, periods):
    """A 2-D level as the march's grid (Wx, 1, Wy): offsets (dx, 0, dy),
    periods (a, 1, b), the color table's flat order unchanged."""
    if len(dims) == 3:
        return tuple(dims), tuple(tuple(d) for d in offsets), tuple(periods)
    return (dims[0], 1, dims[1]), tuple((d[0], 0, d[1]) for d in offsets), (periods[0], 1, periods[1])


def tile_view(cache: "TiledSweepCache") -> "TiledSweepCache":
    """The same smoother on the halo-tile kernel, the march's comparison: a
    2-D level as that kernel's grid (1, Wx, Wy), with the box ``plan_box``
    gives it (ValueError where it gives none, and on bf16 planes, which that
    kernel does not take)."""
    if cache.A.data.dtype != cache.A.dtype:
        raise ValueError(f"the halo-tile kernel takes no {cache.A.data.dtype} planes (the march does)")
    if len(cache.offsets) > MAX_OFFSETS:
        raise ValueError(f"the halo-tile kernel takes {MAX_OFFSETS} offsets, not {len(cache.offsets)}")
    dims, offsets, periods = cache.dims, cache.offsets, cache.periods
    if cache.nd == 2:
        dims, periods = (1, dims[0], dims[2]), (1, periods[0], periods[2])
        offsets = tuple((0, d[0], d[2]) for d in offsets)
    box, why = plan_box(cache.nd, dims, offsets, len(cache.steps), cache.A.data.element_size())
    if box is None:
        raise ValueError(f"the halo-tile kernel does not take this level: {why}")
    return dataclasses.replace(cache, dims=dims, offsets=offsets, periods=periods, box=box, march=None)


def plan_box(nd: int, dims, offsets, n_steps: int, itemsize: int):
    """(box, None) — the loaded box per axis — or (None, why) when the level
    is past the kernel's shape limits: more than 64 color steps, a halo that
    leaves no ``MIN_TILE`` tile within an SM's shared memory, or more tiles
    than a CUDA grid dimension holds."""
    if not 1 <= n_steps <= MAX_STEPS:
        return None, f"{n_steps} color steps (the kernel takes 1..{MAX_STEPS})"
    halo = [n_steps * max(abs(d[a]) for d in offsets) for a in range(3)]
    least = [2 * h + min(MIN_TILE, n) for h, n in zip(halo, dims)]
    box = [min(max(e, lo), n + 2 * h) for e, lo, n, h in zip(BOX[nd], least, dims, halo)]
    # over the limit: halve the axis with the most room above its least box
    while math.prod(box) * itemsize > SMEM_LIMIT:
        a = max(range(3), key=lambda i: box[i] - least[i])
        if box[a] <= least[a]:
            need = math.prod(least) * itemsize
            return None, f"a box of {least} cells needs {need} bytes of shared memory (limit {SMEM_LIMIT})"
        box[a] = max(least[a], (box[a] + least[a]) // 2)
    tiles = [-(-dims[a] // (box[a] - 2 * halo[a])) for a in range(3)]
    if max(tiles[0], tiles[1]) > MAX_TILES:
        return None, f"{tiles} tiles (the grid's axes 0 and 1 take at most {MAX_TILES})"
    return tuple(box), None


def card_shape(device=None) -> Tuple[int, int, int]:
    """(SMs, shared memory bytes an SM, threads an SM) of ``device``'s card,
    from its properties; ``H100_SM`` for a device that is not a card."""
    if device is None or torch.device(device).type != "cuda":
        return H100_SM
    p = torch.cuda.get_device_properties(device)
    return (p.multi_processor_count, getattr(p, "shared_memory_per_multiprocessor", H100_SM[1]),
            getattr(p, "max_threads_per_multi_processor", H100_SM[2]))


def march_segment(n0: int, h0: int, columns: int, smem: int, threads: int, card=H100_SM, batch: int = MARCH_BATCH,
                  per_sm: Optional[int] = None) -> int:
    """The planes a segment owns: the count of segments whose blocks fill
    whole waves of ``card`` (``card_shape``) best, each block's time taken
    as its time steps (its planes, segment plus both end halos, in batches
    of ``batch``), a wave as one block on each of the blocks an SM holds
    times the SMs; of equal costs the fewest segments (the least halo
    work).  The blocks an SM holds are ``per_sm`` (the card's occupancy of
    the kernel instance, registers included) or else what its shared
    memory and threads allow."""
    sms, sm_smem, sm_threads = card
    if per_sm is None:
        per_sm = min(sm_smem // max(smem + SM_SMEM_RESERVE, 1), sm_threads // max(threads, 1))
    slots = sms * max(1, per_sm)

    def cost(n_seg):
        return -(-columns * n_seg // slots) * -(-(-(-n0 // n_seg) + 2 * h0) // batch)

    return -(-n0 // min(range(1, n0 + 1), key=cost))


def march_ring(n_steps: int, r0: int, batch: int = MARCH_BATCH) -> int:
    """x's ring depth in planes (``csrc/sweep_march.cuh`` march_ring): with
    the batch ending at plane M, the planes M − (n_steps+1)·r0 − P + 1 …
    M + depth·P that time M reads or has in flight, and P − r0 more (the
    next loads must not reach the planes this time stores)."""
    return (n_steps + 1) * r0 + batch + MARCH_DEPTH * batch + max(batch - r0, 0)


def plan_march(dims, offsets, n_steps: int, itemsize: int, box=None, seg=None, device=None, coef_itemsize=None):
    """(MarchPlan, None), or (None, why) when the level is past the march's
    limits: more than 64 color steps, a ring that leaves no ``MIN_TILE``
    tile of the y-z box within an SM's shared memory and the block's
    threads, or more columns or segments than a CUDA grid dimension holds.
    The box starts from ``box``; by default ``MARCH_BOX[itemsize]`` on a
    3-D level and, on a Lat2D level (the grid (Wx, 1, Wy)), the strip 1 ×
    (tile + 2 halo) whose tile cuts Wy into whole columns of about
    ``MARCH_STRIP`` cells, a block takes at most ``MARCH_MAX_THREADS_2D``
    threads and a time step ``MARCH_BATCH_2D`` rows.  The segment is
    ``seg`` planes at most (default: ``march_segment`` on ``device``'s card,
    with the occupancy of the kernel instance where ``device`` is a card).
    ``itemsize`` is the vectors' (x's ring), ``coef_itemsize`` the planes'
    (default ``itemsize``; 2 for K7's bf16 instance), which picks the
    instance whose occupancy the card reports."""
    if not 1 <= n_steps <= MAX_STEPS:
        return None, f"{n_steps} color steps (the kernel takes 1..{MAX_STEPS})"
    reach = [max(abs(d[a]) for d in offsets) for a in range(3)]
    halo = [n_steps * r for r in reach]
    flat = dims[1] == 1 and reach[1] == 0  # a Lat2D level
    batch = MARCH_BATCH_2D.get(len(offsets), MARCH_BATCH) if flat else MARCH_BATCH
    ring = march_ring(n_steps, reach[0], batch)
    max_threads = MARCH_MAX_THREADS_2D if flat else MARCH_MAX_THREADS
    if box is None and flat:
        columns = -(-dims[2] // MARCH_STRIP)
        box = (1, -(-dims[2] // columns) + 2 * halo[2])
    elif box is None:
        box = MARCH_BOX.get(itemsize, MARCH_BOX[8])
    least = [2 * halo[a] + min(MIN_TILE, dims[a]) for a in (1, 2)]
    ext = [min(max(e, lo), dims[a] + 2 * halo[a]) for e, lo, a in zip(box, least, (1, 2))]

    def threads(e):  # one step unit a thread
        return e[0] * -(-e[1] // MARCH_UNIT)

    while math.prod(ext) * ring * itemsize > SMEM_LIMIT or threads(ext) > max_threads:
        a = max(range(2), key=lambda i: ext[i] - least[i])
        if ext[a] <= least[a]:
            need = math.prod(least) * ring * itemsize
            return None, (f"a y-z box of {least} cells with a ring of {ring} planes needs {need} bytes of shared"
                          f" memory (limit {SMEM_LIMIT}) and {threads(least)} threads (limit {max_threads})")
        ext[a] = max(least[a], (ext[a] + least[a]) // 2)
    smem = math.prod(ext) * ring * itemsize
    tiles = [-(-dims[a + 1] // (ext[a] - 2 * halo[a + 1])) for a in range(2)]
    if seg is None:
        per_sm = None
        if device is not None and torch.device(device).type == "cuda":
            lib = load_library()
            per_sm = (lib.amg_gs_sweep_march_blocks_per_sm(len(offsets), itemsize, ext[1], smem) if flat else
                      lib.amg_sweep3d_march_blocks_per_sm(len(offsets), itemsize, coef_itemsize or itemsize, *ext,
                                                          smem))
            if per_sm < 1:
                raise RuntimeError(f"the march's occupancy query failed ({per_sm}) for a box of {ext} cells")
        seg = march_segment(dims[0], halo[0], tiles[0] * tiles[1], smem, threads(ext), card_shape(device), batch,
                            per_sm)
    n_seg = -(-dims[0] // seg)
    if max(tiles[0], n_seg) > MAX_TILES:
        return None, f"{tiles[0]} columns on axis 1 and {n_seg} segments (each takes at most {MAX_TILES})"
    return MarchPlan(box=tuple(ext), seg=-(-dims[0] // n_seg), ring=ring, smem=smem, batch=batch), None


def tiled_sweep_cache(
    cls, A, dinv, color_table, n_colors: int, omega: float, iters: int, fwd: bool, bwd: bool, fallback=None,
) -> Optional[TiledSweepCache]:
    """The whole-sweep cache (of class ``cls``) of a lattice level (``A`` a
    Lat2D, or a 3-D LatND with bases (1, 1)) with its march plan, or None —
    logged — when the level is past the march's limits (then the level
    keeps its masked sweep).  ``fallback`` is the level's masked multicolor
    cache, kept for multi-RHS blocks."""
    tab = np.asarray(color_table, dtype=np.int64)
    nd = len(A.row_dims)
    if tab.ndim != nd or nd not in (2, 3):
        raise ValueError(f"a {tab.ndim}-D color table for a {nd}-D level")
    dims, offsets, periods = _as3(A.row_dims, A.offsets, tab.shape)
    steps = color_steps(int(n_colors), int(iters), bool(fwd), bool(bwd), float(omega))
    march = None
    max_off = MARCH_MAX_OFFSETS_2D if nd == 2 else MAX_OFFSETS
    if len(offsets) > max_off:
        why = f"{len(offsets)} offsets (the kernel takes {max_off})"
    elif tab.size > MAX_COLOR_CELLS:
        why = f"a color table of {tab.size} cells (the kernel takes {MAX_COLOR_CELLS})"
    else:
        march, why = plan_march(dims, offsets, len(steps), A.dtype.itemsize, device=A.data.device,
                                coef_itemsize=A.data.element_size())
    if why is not None:
        log.info("level %s keeps the masked sweep: %s", tuple(A.row_dims), why)
        return None
    return cls(
        A=A, dinv=dinv, dims=dims, offsets=offsets, periods=periods,
        color_table=tuple(int(c) for c in tab.ravel()), n_colors=int(n_colors), box=None,
        omega=float(omega), iter=int(iters), forward=bool(fwd), backward=bool(bwd), nd=nd, fallback=fallback,
        march=march,
    )


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------


def _color_field(cache: TiledSweepCache, device) -> torch.Tensor:
    tab = torch.as_tensor(cache.color_table, device=device).view(cache.periods)
    idx = []
    for a, (n, p) in enumerate(zip(cache.dims, cache.periods)):
        shape = [1, 1, 1]
        shape[a] = n
        idx.append((torch.arange(n, device=device) % p).view(shape))
    return tab[tuple(idx)]


def _stencil(planes, X, offsets):
    """Σₖ planes_k ⊙ X[· + dₖ] with zeros outside the grid, summed in offset
    order as the LatND/Lat2D SpMV sums."""
    m = [max(abs(d[a]) for d in offsets) for a in range(3)]
    Xp = torch.nn.functional.pad(X, (m[2], m[2], m[1], m[1], m[0], m[0]))
    n0, n1, n2 = X.shape
    acc = None
    for k, (d0, d1, d2) in enumerate(offsets):
        g = Xp[m[0] + d0 : m[0] + d0 + n0, m[1] + d1 : m[1] + d1 + n1, m[2] + d2 : m[2] + d2 + n2]
        term = planes[k] * g
        acc = term if acc is None else acc + term
    return acc


def tiled_sweep_reference(cache: TiledSweepCache, x, b):
    """The smoother in plain PyTorch: per color step one stencil pass and a
    masked blend; returns a new x of ``x``'s (padded) length."""
    dims = cache.dims
    n = math.prod(dims)
    X = x[:n].reshape(dims)
    B = b[:n].reshape(dims)
    D = cache.dinv[:n].reshape(dims)
    planes = cache.A.data.reshape((-1,) + dims)
    col = _color_field(cache, x.device)
    for c in cache.steps:
        r = B - _stencil(planes, X, cache.offsets)
        X = torch.where(col == c, X + cache.omega * D * r, X)
    out = x.clone()
    out[:n] = X.reshape(n)
    return out


# --------------------------------------------------------------------------
# the launch
# --------------------------------------------------------------------------


def launch_tiled_sweep(cache: TiledSweepCache, x, b, entry: str, counter: str):
    """Run the smoother: the plain version on a CPU tensor, else one launch
    of ``amg_<entry>_march_<f32|f64>`` (``amg_sweep3d_march_f32_bf16`` for
    bf16 planes) on a cache with a march plan or ``amg_<entry>_<f32|f64>``
    on its tile box (counted under ``launches[counter]`` and, by grid,
    ``level_launches``) or an exception."""
    if x.device.type == "cpu":
        return tiled_sweep_reference(cache, x, b)
    if x.device.type != "cuda":
        raise ValueError(f"{entry} runs on cuda or cpu tensors, not {x.device}")
    planes = cache.A.data
    n = math.prod(cache.dims)
    check_vector("x", x, planes, n, cache.A.dtype)
    check_vector("b", b, planes, n, cache.A.dtype)
    if x.dtype not in SUFFIX:
        raise TypeError(f"{entry} takes float32 or float64, not {x.dtype}")
    if not planes.is_contiguous():
        raise ValueError(f"{entry} reads the level's planes in place: they must be contiguous")
    if cache.launch_args is None:
        raise ValueError(f"{entry}: the cache has no plan")
    sfx = SUFFIX[x.dtype]
    if planes.dtype != x.dtype:
        if not (planes.dtype == torch.bfloat16 and x.dtype == torch.float32 and entry == "sweep3d"
                and cache.march is not None):
            raise TypeError(f"{entry} takes no {planes.dtype} planes under {x.dtype} vectors on this route")
        sfx = BF16_SUFFIX[x.dtype]
    fn = getattr(load_library(), f"amg_{entry}{'_march' if cache.march is not None else ''}_{sfx}")
    x_out = torch.empty_like(x)
    err = fn(
        x_out.data_ptr(), x.data_ptr(), b.data_ptr(), planes.data_ptr(), cache.dinv.data_ptr(),
        *cache.launch_args, x.shape[0] - n, cache.omega, _stream(x),
    )
    raise_on(err, f"{entry} kernel")
    launches[counter] += 1
    level_launches[counter, cache.dims] += 1
    return x_out
