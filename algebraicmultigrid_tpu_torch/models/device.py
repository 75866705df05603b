"""Device (PyTorch) solve engine.

Port of the JAX package's ``models/device.py``:

* each level's A/P/R is lowered to the fastest format that holds it:
  Lat2D planes for 2-D lattice levels (``ops/lattice_op.py``), LatND for
  N-D ones (``ops/lattice_nd_op.py``), else SDIA, BTOp
  or DenseOp (``ops/banded.py``), the BSG gather tier (``ops/bsg.py``, K6
  as a CUDA kernel) or padded ELL (``ops/sparse.py``); level vectors stay
  padded to ``rows_padded`` end to end;
* an unstructured level whose natural order does not fit a BSG window
  adopts the RCM-permuted basis ``A[π][:, π]``; π is folded into P/R and
  the smoother caches, and the solve drivers apply it once on entry
  (``perm0``) and exit (``iperm0``);
* smoothers: weighted Jacobi, masked multicolor GS/SOR (one full SpMV +
  masked blend per color step), the whole-sweep kernels K5 on Lat2D levels
  without legs or tail and K7 on 3-D LatND levels (one launch per smoother
  application, ``ops/kernels/gs_sweep.py``, ``ops/kernels/sweep3d.py``),
  gathered multicolor GS/SOR on ELL levels,
  and the exact natural-order recurrence on small ELL levels (a CUDA kernel,
  ``ops/kernels/scan_gs.py``); natural-order GS/SOR above 2048 rows is
  promoted to multicolor, as in the JAX package;
* Lat2D levels with box-k transfers and symmetric multicolor GS/SOR run
  the fused legs (``ops/kernels/vcycle_legs.py``): factored where the SA
  setup stashed the factored prolongator, else through their R/P planes
  (SA with ``NoSymmetry()``, a hierarchy from ``load_hierarchy``);
  hand-written CUDA kernels on the card, their plain versions on the CPU;
* the trailing run of small such levels plus the coarse solve runs as one
  whole-tail V-cycle (``ops/kernels/tail_kernel.py``) in V-cycles; those
  levels build no legs, and W/F cycles run them through the masked sweeps;
* with ``subcycle=True`` the level above the tail, the tail and the coarse
  solve run as one phased whole-subcycle V-cycle from zero
  (``ops/kernels/subcycle_kernel.py``) in the V recursion;
* ``run_fixed_cycles`` runs the top level's cross-cycle updown leg once per
  cycle where that level's legs are factored (K3 takes no R/P planes);
* while a ``torch.profiler`` records (``utils.diagnostics.profile_trace``)
  the cycle marks its phases with
  ``torch.profiler.record_function`` ranges under the JAX package's
  ``jax.named_scope`` names;
* a multi-RHS block ``x[n, k]`` runs through every format's SpMV and every
  smoother, past the legs, the tail and the subcycle (which take a flat
  x), as in the JAX package: K5/K7 caches hand it to their masked
  fallback, K6 and ``scan_gs`` run column by column;
* the V/W/F recursion unrolls in Python over the level list, and the
  iteration loops are Python loops with one host read of the residual norm
  per iteration for the stopping test;
* the coarse solve is a dense QR triangular solve or a pinv matmul
  (coarse_solver.jl:9-16,66-81 semantics, incl. the singular path).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..config import BackwardSweep, Cycle, F, ForwardSweep, GaussSeidel, Jacobi, SOR, SymmetricSweep, V, W
from ..ops.banded import bt_from_csr, dense_from_csr, mat_vec, sdia_from_csr
from ..ops.bsg import bsg_from_csr, rcm_permutation
from ..ops.coloring import color_steps, graph_coloring
from ..ops.kernels.gs_sweep import GSSweepCache, build_gs_sweep_cache, smooth_gs
from ..ops.kernels.scan_gs import ScanGSCache, scan_gs_cache, smooth_scan_gs
from ..ops.kernels.subcycle_kernel import build_fused_subcycle_cache, fused_subcycle
from ..ops.kernels.sweep3d import Sweep3DCache, build_sweep3d_cache, smooth_sweep3d
from ..ops.kernels.tail_kernel import build_fused_tail_cache, fused_tail
from ..ops.kernels.vcycle_legs import build_level_legs, coef_dtype_of, fused_down, fused_up, fused_updown
from ..utils.diagnostics import phase_range
from ..ops.lattice_nd_op import LatND, latnd_from_spec
from ..ops.lattice_op import Lat2D, lat2d_from_spec, pad_rows
from ..ops.sparse import ELL, as_csr, ell_from_csr, np_dtype, round_up
from .coarse import QRSolver
from .lattice import LatticeMatrix
from .lattice_nd import LatticeMatrixND
from .multilevel import MultiLevel

# every level's row space is padded to a multiple of this, as in the JAX
# package, so level vectors line up with its hierarchies
ROW_PAD = 8
# natural-order GS/SOR runs its exact recurrence only up to this many rows;
# larger levels run multicolor ordering, and smaller ones lower to Dense
DENSE_THRESHOLD = 2048

__all__ = [
    "JacobiCache",
    "MulticolorCache",
    "ScanGSCache",
    "MaskedMulticolorCache",
    "CoarseCache",
    "DeviceLevel",
    "DeviceHierarchy",
    "build_device_hierarchy",
    "get_device_hierarchy",
    "device_cycle_fn",
    "run_fixed_cycles",
    "solve_device",
    "cg_device",
    "solve_refined",
]


# --------------------------------------------------------------------------
# containers
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class JacobiCache:
    """x ← x + ω·D⁻¹(b − Ax); zero-diag rows frozen (smoother.jl:101-171)."""

    dinv: torch.Tensor  # [rows_padded], 0 where diag == 0
    omega: float
    iter: int


@dataclasses.dataclass(frozen=True)
class MulticolorCache:
    """Stacked per-color row blocks for gathered multicolor GS/SOR sweeps on
    an ELL level.  Zero-diagonal rows are in no color (frozen); color c
    holds ``sizes[c]`` rows, the rest of its block is padding."""

    rows: torch.Tensor  # int64 [n_colors, cmax]
    data: torch.Tensor  # [n_colors, cmax, width], diagonal slots zeroed
    cols: torch.Tensor  # int64 [n_colors, cmax, width]
    dinv: torch.Tensor  # [n_colors, cmax]
    sizes: Tuple[int, ...]
    omega: float
    iter: int
    forward: bool
    backward: bool


@dataclasses.dataclass(frozen=True)
class MaskedMulticolorCache:
    """Gather-free multicolor GS/SOR: per color, one full SpMV + masked
    blend.  Frozen (zero-diag) and padding rows carry color id = n_colors
    and are never selected."""

    color_of: torch.Tensor  # int32 [rows_padded]
    dinv: torch.Tensor      # [rows_padded]
    n_colors: int
    omega: float
    iter: int
    forward: bool
    backward: bool


@dataclasses.dataclass(frozen=True)
class DeviceLevel:
    A: Any  # Lat2D | LatND | SDIA | BTOp | DenseOp | BSG | ELL
    P: Any
    R: Any
    pre: Any  # one of the smoother caches above
    post: Any
    fused: Any = None  # FusedLegCache — fused down/up legs


@dataclasses.dataclass(frozen=True)
class CoarseCache:
    """Dense coarse solve operand(s)."""

    mat: torch.Tensor   # pinv matrix (kind 'pinv')
    qr_q: torch.Tensor  # Q and R (kind 'qr')
    qr_r: torch.Tensor
    kind: str           # 'pinv' | 'qr'
    n: int
    rows_padded: int


@dataclasses.dataclass(frozen=True)
class DeviceHierarchy:
    levels: Tuple[DeviceLevel, ...]
    coarse: CoarseCache
    final_A: Any = None  # the coarse operator, for a hierarchy with no levels
    tail: Any = None     # FusedTailCache of levels[tail_start:] + coarse solve
    tail_start: int = -1
    sub: Any = None      # FusedSubcycleCache of levels[sub_start:] + coarse solve
    sub_start: int = -1
    # fine-level RCM basis: the cycle runs in the permuted basis; the solve
    # drivers apply perm0 to b on entry and iperm0 to x on exit (int64
    # index vectors extended by the identity over the padding; None =
    # natural order)
    perm0: Optional[torch.Tensor] = None
    iperm0: Optional[torch.Tensor] = None

    @property
    def n_fine(self) -> int:
        return self.levels[0].A.shape[0] if self.levels else self.coarse.n

    @property
    def fine_padded(self) -> int:
        return self.levels[0].A.rows_padded if self.levels else self.coarse.rows_padded


# --------------------------------------------------------------------------
# smoother application
# --------------------------------------------------------------------------


def fit_len(v: torch.Tensor, n: int) -> torch.Tensor:
    """Pad-or-slice the leading axis to exactly n (v flat or [rows, k])."""
    m = v.shape[0]
    if m == n:
        return v
    if m > n:
        return v[:n]
    return pad_rows(v, 0, n - m)


def _rows(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-row vector broadcast against x (flat, or a multi-RHS [n, k])."""
    return v if x.dim() == 1 else v.unsqueeze(-1)


def _smooth_jacobi(cache: JacobiCache, A, x, b):
    n = x.shape[0]
    dinv = _rows(cache.dinv, x)
    for _ in range(cache.iter):
        r = b - fit_len(mat_vec(A, x), n)
        x = x + cache.omega * dinv * r
    return x


def _smooth_masked_multicolor(cache: MaskedMulticolorCache, A, x, b):
    n = x.shape[0]
    dinv, color_of = _rows(cache.dinv, x), _rows(cache.color_of, x)
    for c in color_steps(cache.n_colors, cache.iter, cache.forward, cache.backward, cache.omega):
        r = b - fit_len(mat_vec(A, x), n)
        x = torch.where(color_of == c, x + cache.omega * dinv * r, x)
    return x


def _color_step(cache: MulticolorCache, c: int, x, b):
    """Update the rows of color c in place (they are mutually uncoupled)."""
    s = cache.sizes[c]
    rows = cache.rows[c, :s]
    rsum = (_rows(cache.data[c, :s], x) * x[cache.cols[c, :s]]).sum(dim=1)
    w = cache.omega
    x[rows] = (1 - w) * x[rows] + w * _rows(cache.dinv[c, :s], x) * (b[rows] - rsum)


def _smooth_multicolor(cache: MulticolorCache, A, x, b):
    x = x.clone()
    n_colors = len(cache.sizes)
    for _ in range(cache.iter):
        if cache.forward:
            for c in range(n_colors):
                _color_step(cache, c, x, b)
        if cache.backward:
            for c in range(n_colors - 1, -1, -1):
                _color_step(cache, c, x, b)
    return x


def _apply_smoother(cache, A, x, b):
    if isinstance(cache, (GSSweepCache, Sweep3DCache)) and x.dim() != 1:
        # multi-RHS: the whole-sweep kernels take a flat x; the level's
        # masked sweep runs the block, as in the JAX package
        if cache.fallback is None:
            raise ValueError(f"this {type(cache).__name__} has no masked fallback for a multi-RHS x")
        cache = cache.fallback
    if isinstance(cache, GSSweepCache):
        return smooth_gs(cache, x, b)
    if isinstance(cache, Sweep3DCache):
        return smooth_sweep3d(cache, x, b)
    if isinstance(cache, MaskedMulticolorCache):
        return _smooth_masked_multicolor(cache, A, x, b)
    if isinstance(cache, JacobiCache):
        return _smooth_jacobi(cache, A, x, b)
    if isinstance(cache, MulticolorCache):
        return _smooth_multicolor(cache, A, x, b)
    if isinstance(cache, ScanGSCache):
        return smooth_scan_gs(A, cache, x, b)
    from ..parallel.rows import ShardedSmoother, sharded_smooth

    if isinstance(cache, ShardedSmoother):  # a rank's rows (the sharded tier)
        return sharded_smooth(cache, A, x, b)
    raise TypeError(f"unknown device smoother cache {type(cache).__name__}")


# --------------------------------------------------------------------------
# building the device hierarchy
# --------------------------------------------------------------------------


def _sweep_flags(config):
    omega = float(config.omega) if isinstance(config, SOR) else 1.0
    fwd = isinstance(config.sweep, (ForwardSweep, SymmetricSweep))
    bwd = isinstance(config.sweep, (BackwardSweep, SymmetricSweep))
    return omega, fwd, bwd


def _dinv(diag: np.ndarray, rows_padded: int, dtype) -> np.ndarray:
    """1/diag over the level's rows, 0 where diag == 0 and on the padding."""
    n = diag.shape[0]
    out = np.zeros(rows_padded, dtype=dtype)
    active = diag != 0
    out[:n] = np.where(active, 1.0 / np.where(active, diag, 1), 0.0)
    return out


def _build_lattice_smoother_cache(config, A_lat, A_dev, dtype, device, sweep_kernel=True):
    """O(boundary) smoother cache for a lattice level: periodic torus
    coloring + host diagonal expansion, no O(nnz) graph analysis.  None for
    a config the lattice path does not take (natural-order GS/SOR), which
    then runs on the materialised level.  Multicolor GS/SOR runs K5 when
    ``sweep_kernel`` (the level has no legs and no place in the tail) and
    no cell has a zero diagonal, as in the JAX package; else, or past K5's
    shape limits, the masked sweep."""
    from .lattice import lattice_coloring

    spec = A_lat.spec
    rows_padded = A_dev.rows_padded
    n = A_lat.shape[0]
    np_dt = np_dtype(dtype)
    diag = spec.diagonal().astype(np_dt)
    if isinstance(config, Jacobi):
        dinv = _dinv(diag, rows_padded, np_dt)
        return JacobiCache(dinv=torch.as_tensor(dinv, device=device), omega=float(config.omega), iter=config.iter)
    if not (isinstance(config, (GaussSeidel, SOR)) and config.ordering == "multicolor"):
        return None
    omega, fwd, bwd = _sweep_flags(config)
    got = lattice_coloring(spec)
    if got is None:
        return None
    grid, n_colors = got
    a, b = grid.shape
    Wx, Wy = spec.row_dims
    colors = grid[(np.arange(Wx) % a)[:, None], (np.arange(Wy) % b)[None, :]].ravel()
    active = diag != 0
    color_of = np.full(rows_padded, n_colors, dtype=np.int32)
    color_of[:n] = np.where(active, colors, n_colors)
    dinv = torch.as_tensor(_dinv(diag, rows_padded, np_dt), device=device)
    masked = MaskedMulticolorCache(
        color_of=torch.as_tensor(color_of, device=device),
        dinv=dinv,
        n_colors=int(n_colors),
        omega=omega,
        iter=config.iter,
        forward=fwd,
        backward=bwd,
    )
    if sweep_kernel and isinstance(A_dev, Lat2D) and active.all():
        cache = build_gs_sweep_cache(A_dev, dinv, grid, n_colors, omega, config.iter, fwd, bwd, fallback=masked)
        if cache is not None:
            return cache
    return masked


def _build_lattice_nd_smoother_cache(config, A_lnd, A_dev, dtype, device, sweep_kernel=True):
    """O(boundary) smoother cache for an N-D lattice level (the JAX
    package's ``_build_lattice_nd_smoother_cache``): periodic torus coloring
    + host diagonal expansion.  Multicolor GS/SOR on a 3-D level with no
    zero diagonal runs K7 when ``sweep_kernel``; else, or past K7's shape
    limits, the masked sweep.  None for natural-order GS/SOR."""
    from .lattice_nd import lattice_coloring_nd

    spec = A_lnd.spec
    rows_padded = A_dev.rows_padded
    n = A_lnd.shape[0]
    diag = spec.diagonal()
    active = diag != 0
    dinv = torch.as_tensor(_dinv(diag, rows_padded, np_dtype(dtype)), device=device)
    if isinstance(config, Jacobi):
        return JacobiCache(dinv=dinv, omega=float(config.omega), iter=config.iter)
    if not (isinstance(config, (GaussSeidel, SOR)) and config.ordering == "multicolor"):
        return None
    got = lattice_coloring_nd(spec)
    if got is None:
        return None
    tab, n_colors = got
    omega, fwd, bwd = _sweep_flags(config)
    reps = [-(-W // p) for W, p in zip(spec.row_dims, tab.shape)]
    colors = np.tile(tab, reps)[tuple(slice(0, W) for W in spec.row_dims)].ravel()
    color_of = np.full(rows_padded, n_colors, dtype=np.int32)
    color_of[:n] = np.where(active, colors, n_colors)
    masked = MaskedMulticolorCache(
        color_of=torch.as_tensor(color_of, device=device),
        dinv=dinv,
        n_colors=int(n_colors),
        omega=omega,
        iter=config.iter,
        forward=fwd,
        backward=bwd,
    )
    if sweep_kernel and isinstance(A_dev, LatND) and spec.ndim == 3 and active.all():
        cache = build_sweep3d_cache(A_dev, dinv, tab, n_colors, omega, config.iter, fwd, bwd, fallback=masked)
        if cache is not None:
            return cache
    return masked


def _build_masked_multicolor_cache(A_csr, rows_padded, dtype, device, omega, iters, fwd, bwd, sym=False):
    n = A_csr.shape[0]
    colors = graph_coloring(A_csr, assume_symmetric=sym)
    diag = A_csr.diagonal()
    n_colors = int(colors.max()) + 1 if n else 1
    color_of = np.full(rows_padded, n_colors, dtype=np.int32)
    color_of[:n] = np.where(diag != 0, colors, n_colors)
    return MaskedMulticolorCache(
        color_of=torch.as_tensor(color_of, device=device),
        dinv=torch.as_tensor(_dinv(diag, rows_padded, np_dtype(dtype)), device=device),
        n_colors=n_colors,
        omega=omega,
        iter=iters,
        forward=fwd,
        backward=bwd,
    )


def multicolor_cache(rows, data, cols, dinv, rows_padded, dtype, device, omega, iters, fwd, bwd):
    """MulticolorCache from its host arrays (rows padded with the sentinel
    ``rows_padded``, as the JAX package's cache holds them)."""
    rows = np.asarray(rows)
    return MulticolorCache(
        rows=torch.as_tensor(rows.astype(np.int64), device=device),
        data=torch.as_tensor(np.array(data), device=device).to(dtype),
        cols=torch.as_tensor(np.asarray(cols).astype(np.int64), device=device),
        dinv=torch.as_tensor(np.array(dinv), device=device).to(dtype),
        sizes=tuple(int(v) for v in (rows != rows_padded).sum(axis=1)),
        omega=float(omega),
        iter=int(iters),
        forward=bool(fwd),
        backward=bool(bwd),
    )


def _build_multicolor_cache(A_csr, A_ell: ELL, dtype, device, omega, iters, fwd, bwd, sym=False):
    n = A_csr.shape[0]
    colors = graph_coloring(A_csr, assume_symmetric=sym)
    diag = A_csr.diagonal()
    active = diag != 0  # zero-diag rows frozen
    n_colors = int(colors.max()) + 1 if n else 1
    groups = [np.flatnonzero((colors == c) & active) for c in range(n_colors)]
    groups = [g for g in groups if g.size > 0] or [np.zeros(0, dtype=np.int64)]
    cmax = max(max(g.size for g in groups), 1)
    width = A_ell.width
    sentinel = A_ell.rows_padded
    np_dt = np_dtype(dtype)
    rows = np.full((len(groups), cmax), sentinel, dtype=np.int64)
    data = np.zeros((len(groups), cmax, width), dtype=np_dt)
    cols = np.zeros((len(groups), cmax, width), dtype=np.int64)
    dinv = np.zeros((len(groups), cmax), dtype=np_dt)
    h_data = A_ell.data.cpu().numpy()
    h_cols = A_ell.cols.cpu().numpy()
    for c, g in enumerate(groups):
        rows[c, : g.size] = g
        dd = h_data[g].copy()
        cc = h_cols[g]
        dd[cc == g[:, None]] = 0  # zero the diagonal slots → rsum is off-diag
        data[c, : g.size] = dd
        cols[c, : g.size] = cc
        dinv[c, : g.size] = 1.0 / diag[g]
    return multicolor_cache(rows, data, cols, dinv, sentinel, dtype, device, omega, iters, fwd, bwd)


def _build_smoother_cache(config, A_host, A_dev, dtype, device, sym=False, sweep_kernel=True):
    """The device smoother cache of one level (``A_host`` in the level's
    device basis: the RCM-permuted matrix where the level adopted it).
    ``sweep_kernel`` lets a lattice level run its whole-sweep kernel (K5,
    K7); the builder passes False for levels whose legs or tail run the
    cycle, as the JAX package's ``_AMG_SKIP_PALLAS_GS`` does."""
    if isinstance(A_host, LatticeMatrixND):
        cache = _build_lattice_nd_smoother_cache(config, A_host, A_dev, dtype, device, sweep_kernel)
        if cache is not None:
            return cache
        A_host = A_host.tocsr()  # natural-order GS: materialise
    if isinstance(A_host, LatticeMatrix):
        cache = _build_lattice_smoother_cache(config, A_host, A_dev, dtype, device, sweep_kernel)
        if cache is not None:
            return cache
        A_host = A_host.tocsr()  # natural-order GS: materialise

    rows_padded = A_dev.rows_padded
    np_dt = np_dtype(dtype)
    if isinstance(config, Jacobi):
        dinv = _dinv(A_host.diagonal().astype(np_dt), rows_padded, np_dt)
        return JacobiCache(dinv=torch.as_tensor(dinv, device=device), omega=float(config.omega), iter=config.iter)
    if isinstance(config, (GaussSeidel, SOR)):
        omega, fwd, bwd = _sweep_flags(config)
        if config.ordering == "multicolor":
            if isinstance(A_dev, ELL):
                return _build_multicolor_cache(A_host, A_dev, dtype, device, omega, config.iter, fwd, bwd, sym=sym)
            return _build_masked_multicolor_cache(
                A_host, rows_padded, dtype, device, omega, config.iter, fwd, bwd, sym=sym
            )
        if not isinstance(A_dev, ELL):
            raise TypeError("natural-order GS requires the ELL device format")
        d = np.zeros(rows_padded, dtype=np_dt)
        d[: A_host.shape[0]] = A_host.diagonal().astype(np_dt)
        return scan_gs_cache(A_dev, torch.as_tensor(d, device=device), omega, config.iter, fwd, bwd)
    raise TypeError(f"unknown smoother config {config!r}")


def _build_coarse_cache(ml: MultiLevel, dtype, device, rows_padded: int) -> CoarseCache:
    cs = ml.coarse_solver
    n = ml.final_A.shape[0]
    np_dt = np_dtype(dtype)
    zero = torch.zeros((0, 0), dtype=dtype, device=device)
    if isinstance(cs, QRSolver) and not cs._singular and cs.Q is not None:
        return CoarseCache(
            mat=zero,
            qr_q=torch.as_tensor(cs.Q.astype(np_dt), device=device),
            qr_r=torch.as_tensor(cs.R.astype(np_dt), device=device),
            kind="qr",
            n=n,
            rows_padded=rows_padded,
        )
    pinvA = cs.pinvA if getattr(cs, "pinvA", None) is not None else np.linalg.pinv(
        ml.final_A.toarray()
    )
    return CoarseCache(
        mat=torch.as_tensor(pinvA.astype(np_dt), device=device),
        qr_q=zero,
        qr_r=zero,
        kind="pinv",
        n=n,
        rows_padded=rows_padded,
    )


def device_config(cfg, n: int):
    """The smoother config the device engine runs: natural-order GS/SOR is
    an O(n) sequential recurrence, so above ``DENSE_THRESHOLD`` rows it is
    promoted to multicolor ordering (the same smoother family; the
    reference's contract is convergence, not sweep order)."""
    if isinstance(cfg, (GaussSeidel, SOR)) and cfg.ordering == "natural" and n > DENSE_THRESHOLD:
        return dataclasses.replace(cfg, ordering="multicolor")
    return cfg


def _needs_ell(level) -> bool:
    """Natural-order GS/SOR runs its exact recurrence over ELL rows."""
    n = level.A.shape[0]
    for cfg in (level.presmoother_config, level.postsmoother_config):
        dc = device_config(cfg, n)
        if isinstance(dc, (GaussSeidel, SOR)) and dc.ordering == "natural":
            return True
    return False


def _permute_rect(M, prow, pcol):
    """Fold level bases into a transfer operator: rows by this level's
    permutation, columns by the neighbour level's."""
    if prow is None and pcol is None:
        return M
    C = M.tocsr() if hasattr(M, "tocsr") else sp.csr_matrix(M)
    if prow is not None:
        C = C[prow]
    if pcol is not None:
        C = C[:, pcol]
    return C.tocsr()


def build_device_hierarchy(
    ml: MultiLevel, *, device, dtype, fused: bool = True, tail: bool = True,
    tail_max_rows: int = 250_000, sweeps: bool = True, subcycle: bool = False, coef_dtype=None,
    row_pad: int = ROW_PAD,
) -> DeviceHierarchy:
    """Lower a host hierarchy to device tensors.

    Each level's A/P/R goes to the first format that takes it: Lat2D for a
    ``LatticeMatrix``, LatND for a ``LatticeMatrixND``, else SDIA → BTOp → DenseOp (at most
    ``DENSE_THRESHOLD`` rows and columns) → BSG in natural order (windows of
    at most 64 blocks) → ELL.  A square level that falls through to ELL
    tries the RCM basis: if ``A[π][:, π]`` is BSG-viable, the level adopts
    it, and π is folded into its P/R, its smoother caches and, at the fine
    level, ``perm0``/``iperm0``.  Natural-order GS/SOR levels (at most
    ``DENSE_THRESHOLD`` rows) lower to ELL for the exact recurrence.

    ``fused=False`` skips the fused legs of lattice levels.  ``tail`` builds
    the whole-tail cache from the first level (in order) at which the tail
    gate holds with at most ``tail_max_rows`` rows; the levels it covers
    build no legs.  ``sweeps`` lets multicolor GS/SOR lattice levels run
    their whole-sweep kernel: K5 on a Lat2D level with neither legs nor a
    place in the tail, K7 on a 3-D LatND level; ``sweeps=False`` keeps the
    masked sweep there.  ``subcycle`` builds, when the tail starts at level
    2 or deeper, the phased whole-subcycle cache of the level above it
    (``sub_start = tail_start − 1``, where its gate holds); V-cycles then
    run that level, the tail and the coarse solve as one call.
    ``coef_dtype=torch.bfloat16`` stores, under float32 or float64
    vectors, the coefficient planes of the legs (A, D⁻¹, T, S, computed at
    float32 and rounded) and of the whole-tail levels (A, T, S rounded from
    ``dtype``; D⁻¹ and the coarse operator stay at ``dtype``) in bf16, and
    under float32 only, as the JAX package does, the planes of N-D lattice
    levels' A, P and R (LatND, read in place by K7); every other level
    operator, the smoother caches' D⁻¹ and the unstructured path keep
    ``dtype``.  With ``subcycle`` the subcycle's top level stores its A, T
    and S in bf16 rounded from ``dtype`` and its D⁻¹ at ``dtype``, as a
    tail level does (the JAX package's subcycle cache).  ``row_pad`` pads
    every level's row space to a multiple of it (the sharded tier pads to
    ``8·n_sh``).  The keywords are the counterparts of the JAX package's
    ``AMG_PALLAS_FUSED``/``AMG_PALLAS_TAIL``, ``AMG_TAIL_MAX_ROWS``,
    ``AMG_PALLAS_GS``/``AMG_SWEEP3D``, ``AMG_PALLAS_SUB`` and
    ``AMG_COEF_DTYPE``."""
    device = torch.device(device)
    coef_dtype = coef_dtype_of(coef_dtype, dtype)
    # the JAX package's LatND takes bf16 planes under float32 only
    nd_coef = coef_dtype if dtype == torch.float32 else None

    def lower(M, target_pad, force_ell=False):
        if isinstance(M, LatticeMatrixND):
            if not force_ell:
                return latnd_from_spec(M.spec, dtype, device, row_pad=target_pad, coef_dtype=nd_coef)
            M = M.tocsr()
        if isinstance(M, LatticeMatrix):
            if not force_ell:
                return lat2d_from_spec(M.spec, dtype, device, row_pad=target_pad)
            M = M.tocsr()
        M = as_csr(M)
        if not force_ell:
            # smaller levels tolerate wider diagonal sets (padding overhead
            # is bounded separately by max_overhead)
            mo = 40 if max(M.shape) > 100_000 else 96
            op = sdia_from_csr(M, dtype, device, row_pad=target_pad, max_offsets=mo, max_overhead=8.0)
            if op is None:
                op = bt_from_csr(M, dtype, device, row_pad=target_pad)
            if op is None and max(M.shape) <= DENSE_THRESHOLD:
                op = dense_from_csr(M, dtype, device, row_pad=target_pad)
            if op is None:
                op = bsg_from_csr(M, dtype, device, row_pad=target_pad, ws_cap=64)
            if op is not None:
                return op
        return ell_from_csr(M, dtype, device, row_pad=target_pad)

    def lower_square(level):
        M = level.A
        force = _needs_ell(level)
        if isinstance(M, (LatticeMatrix, LatticeMatrixND)) or force:
            return lower(M, row_pad, force_ell=force), None, None
        A_dev = lower(M, row_pad)
        if not isinstance(A_dev, ELL):
            return A_dev, None, None
        # natural order fell through to the gather tier: try the RCM basis
        A_csr = as_csr(M)
        pi = rcm_permutation(A_csr)
        if np.array_equal(pi, np.arange(A_csr.shape[0])):
            return A_dev, None, None
        Ap = A_csr[pi][:, pi].tocsr()
        G = bsg_from_csr(Ap, dtype, device, row_pad=row_pad)
        if G is None:
            return A_dev, None, None
        return G, pi, Ap

    lowered = [lower_square(level) for level in ml.levels]
    pads = [A_dev.rows_padded for A_dev, _, _ in lowered]
    perms = [pi for _, pi, _ in lowered] + [None]  # the coarse level stays natural
    final_pad = round_up(max(ml.final_A.shape[0], 1), row_pad)
    pads.append(final_pad)

    tail_cache, tail_start = None, -1
    if tail:
        for start in range(len(ml.levels)):
            tail_cache = build_fused_tail_cache(
                ml.levels, ml, start, dtype, device, max_rows=tail_max_rows, coef_dtype=coef_dtype
            )
            if tail_cache is not None:
                tail_start = start
                break

    sym = type(ml.symmetry).__name__ == "HermitianSymmetry"
    out = []
    for i, (level, (A_dev, _, Ap)) in enumerate(zip(ml.levels, lowered)):
        # P maps coarse → this level's rows; R maps this level → coarse rows
        pf, pc = perms[i], perms[i + 1]
        P_dev = lower(_permute_rect(level.P, pf, pc), pads[i])
        R_dev = lower(_permute_rect(level.R, pc, pf), pads[i + 1])
        covered = tail_cache is not None and i >= tail_start
        legs = build_level_legs(level, dtype, device, coef_dtype) if fused and not covered else None
        # levels whose legs or tail run the cycle keep the masked caches for
        # the W/F cycles
        kernel = sweeps and legs is None and not covered
        A_host = Ap if Ap is not None else level.A
        n = level.A.shape[0]
        pre, post = (
            _build_smoother_cache(device_config(cfg, n), A_host, A_dev, dtype, device, sym=sym, sweep_kernel=kernel)
            for cfg in (level.presmoother_config, level.postsmoother_config)
        )
        out.append(DeviceLevel(A=A_dev, P=P_dev, R=R_dev, pre=pre, post=post, fused=legs))

    # sub_start must be a coarse level (its cycle starts from zero); level 0
    # receives real iterates and keeps its own kernels
    sub, sub_start = None, -1
    if subcycle and tail_cache is not None and tail_start >= 2:
        sub = build_fused_subcycle_cache(
            ml.levels, ml, tail_start - 1, dtype, device, legs=out[tail_start - 1].fused, tail=tail_cache,
            coef_dtype=coef_dtype,
        )
        if sub is not None:
            sub_start = tail_start - 1

    perm0 = iperm0 = None
    if perms[0] is not None:
        pi0 = perms[0]
        ext = np.arange(len(pi0), pads[0])
        perm0 = torch.as_tensor(np.concatenate([pi0, ext]), device=device)
        iperm0 = torch.as_tensor(np.concatenate([np.argsort(pi0), ext]), device=device)

    return DeviceHierarchy(
        levels=tuple(out),
        coarse=_build_coarse_cache(ml, dtype, device, final_pad),
        final_A=lower(ml.final_A, row_pad),
        tail=tail_cache,
        tail_start=tail_start,
        sub=sub,
        sub_start=sub_start,
        perm0=perm0,
        iperm0=iperm0,
    )


# --------------------------------------------------------------------------
# cycling
# --------------------------------------------------------------------------


def _coarse_solve(coarse: CoarseCache, b):
    b_log = b[: coarse.n]
    if coarse.kind == "qr":
        y = coarse.qr_q.T @ b_log
        if y.dim() == 1:
            x = torch.linalg.solve_triangular(coarse.qr_r, y[:, None], upper=True)[:, 0]
        else:
            x = torch.linalg.solve_triangular(coarse.qr_r, y, upper=True)
    else:
        x = coarse.mat @ b_log
    return fit_len(x, coarse.rows_padded)


def _cycle(h: DeviceHierarchy, cycle: Cycle, x, b, lvl: int, x_zero: bool = False):
    """One cycle at level lvl — structure of multilevel.jl:214-239.

    ``x_zero`` marks x as the zero vector (coarse-level recursion always
    starts from the zero guess, multilevel.jl:225): the fused down leg then
    does not read x."""
    if h.sub is not None and lvl == h.sub_start and isinstance(cycle, V) and x.dim() == 1 and x_zero:
        # this level, every level below it and the coarse solve, one call
        # from the zero guess.  Unlike the JAX package's branch it requires
        # x_zero: an F cycle's V pass reaches this level with a nonzero x.
        with phase_range(f"L{lvl}/fused_subcycle"):
            return fit_len(fused_subcycle(h.sub, b), x.shape[0])
    if h.tail is not None and lvl == h.tail_start and isinstance(cycle, V) and x.dim() == 1:
        # every level from here down plus the coarse solve, one call
        with phase_range(f"L{lvl}/fused_tail"):
            return fused_tail(h.tail, x, b, x_zero=x_zero)

    level = h.levels[lvl]
    n_here = x.shape[0]
    n_next = h.levels[lvl + 1].A.rows_padded if lvl + 1 < len(h.levels) else h.coarse.rows_padded

    # the legs take a flat x; a multi-RHS block runs the level's masked
    # sweeps and transfer operators, as in the JAX package
    legs = level.fused if x.dim() == 1 else None
    if legs is not None:
        with phase_range(f"L{lvl}/down"):
            x, coarse_b = fused_down(legs, x, b, x_zero=x_zero)
            coarse_b = fit_len(coarse_b, n_next)
    else:
        with phase_range(f"L{lvl}/presmooth"):
            x = _apply_smoother(level.pre, level.A, x, b)
        with phase_range(f"L{lvl}/residual"):
            res = b - fit_len(mat_vec(level.A, x), n_here)
        with phase_range(f"L{lvl}/restrict"):
            coarse_b = fit_len(mat_vec(level.R, res), n_next)

    if lvl == len(h.levels) - 1:
        with phase_range("coarse_solve"):
            coarse_x = _coarse_solve(h.coarse, coarse_b)
    else:
        coarse_x = _next(h, cycle, torch.zeros_like(coarse_b), coarse_b, lvl + 1, x_zero=True)

    if legs is not None:
        with phase_range(f"L{lvl}/up"):
            return fused_up(legs, x, b, coarse_x)
    with phase_range(f"L{lvl}/prolong"):
        x = x + fit_len(mat_vec(level.P, coarse_x), n_here)
    with phase_range(f"L{lvl}/postsmooth"):
        return _apply_smoother(level.post, level.A, x, b)


def _next(h, cycle, x, b, lvl, x_zero: bool = False):
    if isinstance(cycle, V):
        return _cycle(h, cycle, x, b, lvl, x_zero=x_zero)
    if isinstance(cycle, W):
        x = _cycle(h, cycle, x, b, lvl, x_zero=x_zero)
        return _cycle(h, cycle, x, b, lvl)
    if isinstance(cycle, F):
        x = _cycle(h, cycle, x, b, lvl, x_zero=x_zero)
        return _cycle(h, V(), x, b, lvl)
    raise TypeError(f"unknown cycle {cycle!r}")


def _one_iteration(h: DeviceHierarchy, cycle: Cycle, x, b):
    if h.levels:
        return _cycle(h, cycle, x, b, 0)
    return _coarse_solve(h.coarse, b)


def _subsolve(h: DeviceHierarchy, coarse_b, lvl: int):
    """One V-cycle from zero on the sub-hierarchy below ``lvl − 1``."""
    if lvl >= len(h.levels):
        return _coarse_solve(h.coarse, coarse_b)
    return _cycle(h, V(), torch.zeros_like(coarse_b), coarse_b, lvl, x_zero=True)


def run_fixed_cycles(h: DeviceHierarchy, x, b, n_cycles: int):
    """``n_cycles`` V-cycles, the same math as iterating
    :func:`_one_iteration`.  When the top level has factored fused legs (and
    the tail does not start there), the loop is: the down leg once, then per cycle
    the sub-hierarchy's V-cycle and the cross-cycle ``fused_updown`` (up of
    this cycle and down of the next in one launch; the up then the down leg
    on a level whose legs have no updown tile), and a last sub-cycle and
    up leg.  Its rounding differs from the iterated cycles by the deduped
    boundary step of the double sweep."""
    fused = h.levels[0].fused if h.levels else None
    usable = (
        n_cycles >= 1
        and fused is not None
        and fused.factored
        and x.dim() == 1
        and not (h.tail is not None and h.tail_start == 0)
    )
    if not usable:
        for _ in range(n_cycles):
            x = _one_iteration(h, V(), x, b)
        return x

    n_next = h.levels[1].A.rows_padded if len(h.levels) > 1 else h.coarse.rows_padded
    with phase_range("L0/down"):
        xf, bc = fused_down(fused, x, b)
    for _ in range(n_cycles - 1):
        xc = _subsolve(h, fit_len(bc, n_next), 1)
        if fused.updown_tile is None:
            # past the tiled updown's limits (decided when the cache was built)
            with phase_range("L0/down"):
                xf, bc = fused_down(fused, fused_up(fused, xf, b, xc), b)
        else:
            with phase_range("L0/updown"):
                xf, bc = fused_updown(fused, xf, b, xc)
    xc = _subsolve(h, fit_len(bc, n_next), 1)
    with phase_range("L0/up"):
        return fused_up(fused, xf, b, xc)


def _resolve(ml: MultiLevel, device, dtype):
    """Defaults: the card, and the hierarchy's dtype.  With no ``device``
    and no card this raises; the CPU runs only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA card is available: the torch engine runs on the card; "
                "pass device='cpu' to run its plain PyTorch versions on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, dtype=ml.dtype)).dtype
    elif isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return device, dtype


def get_device_hierarchy(
    ml: MultiLevel, device=None, dtype=None, *, subcycle: bool = False, coef_dtype=None,
) -> DeviceHierarchy:
    """The device hierarchy the solve drivers use for (device, dtype,
    subcycle, coef_dtype), built on first use and cached on ``ml``."""
    device, dtype = _resolve(ml, device, dtype)
    coef_dtype = coef_dtype_of(coef_dtype, dtype)
    key = ("torch-hierarchy", str(device), str(dtype), bool(subcycle), str(coef_dtype))
    if key not in ml._device_cache:
        ml._device_cache[key] = build_device_hierarchy(
            ml, device=device, dtype=dtype, subcycle=subcycle, coef_dtype=coef_dtype
        )
    return ml._device_cache[key]


# --------------------------------------------------------------------------
# solve drivers
# --------------------------------------------------------------------------


def _enter_basis(h: DeviceHierarchy, v):
    """b → the hierarchy's fine-level basis (RCM for BSG levels)."""
    return v if h.perm0 is None else v[h.perm0]


def _exit_basis(h: DeviceHierarchy, v):
    """x back to the caller's natural ordering."""
    return v if h.iperm0 is None else v[h.iperm0]


def _fine_op(h: DeviceHierarchy):
    return h.levels[0].A if h.levels else h.final_A


def _solve_fused(h: DeviceHierarchy, b, maxiter, abstol, cycle, calculate_residual):
    """Stationary iteration (multilevel.jl:158-198 semantics) from x = 0;
    ``b`` and the returned x are in the caller's ordering.  Returns
    (x, iterations, ‖r‖)."""
    b = _enter_basis(h, b)
    A = _fine_op(h)
    x = torch.zeros_like(b)
    normres = float(torch.linalg.norm(b))
    itr = 1
    while itr <= maxiter and (not calculate_residual or normres > abstol):
        x = _one_iteration(h, cycle, x, b)
        if calculate_residual:
            normres = float(torch.linalg.norm(b - fit_len(mat_vec(A, x), b.shape[0])))
        itr += 1
    return _exit_basis(h, x), itr - 1, normres


def _dot(a, b):
    """⟨a, b⟩ over every entry, as ``jnp.vdot`` takes it (a multi-RHS block
    is one vector of the block-diagonal system)."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _pcg_fused(h: DeviceHierarchy, b, maxiter, abstol, cycle):
    """Preconditioned CG with one AMG cycle (zero initial guess, fixed,
    linear — preconditioner.jl:12-19 contract) per iteration; ``b`` and the
    returned x are in the caller's ordering.  Returns (x, iterations, ‖r‖)."""
    b = _enter_basis(h, b)
    A = _fine_op(h)
    n_pad = b.shape[0]

    def M(r):
        return _one_iteration(h, cycle, torch.zeros_like(r), r)

    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rz = _dot(r, z)
    itr = 0
    normr = float(torch.linalg.norm(r))
    while itr < maxiter and normr > abstol:
        Ap = fit_len(mat_vec(A, p), n_pad)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        itr += 1
        normr = float(torch.linalg.norm(r))
    return _exit_basis(h, x), itr, normr


def _upload(h: DeviceHierarchy, b, device, dtype):
    """(b at the fine level's padded length, n) on the device."""
    b_arr = torch.as_tensor(np.asarray(b), device=device).to(dtype)
    return fit_len(b_arr, h.fine_padded), b_arr.shape[0]


def cg_device(
    ml: MultiLevel,
    b,
    cycle: Cycle = V(),
    *,
    tol: float = 1e-8,
    abstol: float = 0.0,
    maxiter: int = 100,
    device=None,
    dtype=None,
    log: bool = False,
    subcycle: bool = False,
    coef_dtype=None,
):
    """AMG-preconditioned conjugate gradients on the device.  ``subcycle``
    and ``coef_dtype`` here and in the other drivers run the hierarchy
    built with those keywords of ``build_device_hierarchy``."""
    device, dtype = _resolve(ml, device, dtype)
    h = get_device_hierarchy(ml, device, dtype, subcycle=subcycle, coef_dtype=coef_dtype)
    bp, n = _upload(h, b, device, dtype)
    thresh = max(tol * float(torch.linalg.norm(bp)), abstol)
    x, itr, normr = _pcg_fused(h, bp, maxiter, thresh, cycle)
    xout = x[:n].cpu().numpy()
    return (xout, int(itr), float(normr)) if log else xout


def solve_device(
    ml: MultiLevel,
    b,
    cycle: Cycle = V(),
    *,
    x=None,
    maxiter: int = 100,
    abstol: float = 0.0,
    reltol: Optional[float] = None,
    verbose: bool = False,
    log: bool = False,
    calculate_residual: bool = True,
    device=None,
    dtype=None,
    subcycle: bool = False,
    coef_dtype=None,
):
    """Device-engine solve (mirrors solve_mg / multilevel.jl:158-198).  As
    in the JAX package, the initial guess ``x`` is used only on the logged
    (``log`` or ``verbose``) path; the other path starts from zero."""
    device, dtype = _resolve(ml, device, dtype)
    h = get_device_hierarchy(ml, device, dtype, subcycle=subcycle, coef_dtype=coef_dtype)
    bp, n = _upload(h, b, device, dtype)
    if reltol is None:
        reltol = math.sqrt(torch.finfo(dtype).eps)
    normb = float(torch.linalg.norm(bp))
    if normb != 0:
        abstol = max(reltol * normb, abstol)

    if not (log or verbose):
        xq, _, _ = _solve_fused(h, bp, maxiter, abstol, cycle, calculate_residual)
        return xq[:n].cpu().numpy()

    # observed path: one cycle per iteration, host-side logging, state in the
    # hierarchy's (possibly RCM-permuted) basis
    A = _fine_op(h)
    bq = _enter_basis(h, bp)
    xq = torch.zeros_like(bq) if x is None else _enter_basis(h, _upload(h, x, device, dtype)[0])
    residuals = [normb]
    normres = normb
    itr = 1
    while itr <= maxiter and ((not calculate_residual) or normres > abstol):
        if verbose:
            print(f"Norm of residual at iteration {itr:6d} is {normres:.4e}")
        xq = _one_iteration(h, cycle, xq, bq)
        normres = float(torch.linalg.norm(bq - fit_len(mat_vec(A, xq), bq.shape[0])))
        residuals.append(normres)
        itr += 1
    xout = _exit_basis(h, xq)[:n].cpu().numpy()
    return (xout, residuals) if log else xout


def device_cycle_fn(
    ml: MultiLevel, cycle: Cycle = V(), *, device=None, dtype=None, subcycle: bool = False, coef_dtype=None,
):
    """A function ``b -> x`` applying exactly one cycle from zero — the
    preconditioner contract (preconditioner.jl:12-19).  ``b`` may be a host
    array or a device tensor; x comes back on the device in the caller's
    ordering (the RCM basis, where the hierarchy has one, is entered and
    left around the cycle)."""
    device, dtype = _resolve(ml, device, dtype)
    h = get_device_hierarchy(ml, device, dtype, subcycle=subcycle, coef_dtype=coef_dtype)

    def apply(b):
        bp, n = _upload(h, b, device, dtype)
        bq = _enter_basis(h, bp)
        return _exit_basis(h, _one_iteration(h, cycle, torch.zeros_like(bq), bq))[:n]

    return apply


def _get_fine_f64(ml: MultiLevel, device):
    """f64 device operator of the fine level in the caller's ordering — the
    outer-residual carrier of :func:`solve_refined`: Lat2D, LatND, SDIA,
    dense up to 4096 rows, else a gathered ELL."""
    key = ("torch-fine64", str(device))
    if key not in ml._device_cache:
        A = ml.levels[0].A if ml.levels else ml.final_A
        if isinstance(A, LatticeMatrix):
            op = lat2d_from_spec(A.spec, torch.float64, device, row_pad=ROW_PAD)
        elif isinstance(A, LatticeMatrixND):
            op = latnd_from_spec(A.spec, torch.float64, device, row_pad=ROW_PAD)
        else:
            A_csr = as_csr(A)
            op = sdia_from_csr(A_csr, torch.float64, device, max_offsets=40, max_overhead=8.0)
            if op is None and max(A_csr.shape) <= 4096:
                op = dense_from_csr(A_csr, torch.float64, device)
            if op is None:
                op = ell_from_csr(A_csr, torch.float64, device, row_pad=ROW_PAD)
        ml._device_cache[key] = op
    return ml._device_cache[key]


def solve_refined(
    ml: MultiLevel,
    b,
    cycle: Cycle = V(),
    *,
    tol: float = 1e-8,
    inner: str = "cg",
    inner_tol: float = 1e-5,
    inner_maxiter: int = 40,
    max_rounds: int = 4,
    dtype="float32",
    device=None,
    log: bool = False,
    return_device: bool = False,
    stats: Optional[dict] = None,
    subcycle: bool = False,
    coef_dtype=None,
):
    """Mixed-precision iterative refinement: float32 AMG inner solves under
    a float64 outer residual loop:

        r = b − A·x            (f64, one SpMV per round)
        solve A·e ≈ r in f32   (AMG-PCG or V-cycles to ``inner_tol``)
        x ← x + e              (f64)

    The outer loop runs on the device with the fine operator's f64 lowering
    (:func:`_get_fine_f64`): per round the host reads one scalar norm.
    Unlike the JAX package, which takes the f64 residual of a gathered fine
    level on the host for want of fast f64 on a TPU, a GPU gathers f64 as
    it gathers f32, bound by memory, so no round leaves the device.  ``b``
    may be a device tensor (skips the upload); ``return_device=True``
    returns the f64 solution on the device.  ``stats``, when given, receives
    the inner iteration count of each round under ``"inner_iters"``.
    ``coef_dtype=torch.bfloat16`` runs the inner solves with bf16 planes
    (``build_device_hierarchy``); the f64 outer residual is unchanged."""
    device, dtype = _resolve(ml, device, dtype)
    h = get_device_hierarchy(ml, device, dtype, subcycle=subcycle, coef_dtype=coef_dtype)
    A64 = _get_fine_f64(ml, device)
    n = h.n_fine
    if isinstance(b, torch.Tensor):
        b64 = b.to(device=device, dtype=torch.float64)
    else:
        b64 = torch.as_tensor(np.asarray(b, dtype=np.float64), device=device)
    b64 = fit_len(b64, h.fine_padded)
    normb = float(torch.linalg.norm(b64))
    if normb == 0:
        out = torch.zeros(n, dtype=torch.float64, device=device)
        out = out if return_device else out.cpu().numpy()
        return (out, [0.0]) if log else out
    x64 = torch.zeros_like(b64)
    r64 = b64
    history = [normb]
    inner_iters = []
    for _ in range(max_rounds):
        if history[-1] <= tol * normb:
            break
        scale = history[-1]
        bp = (r64 / scale).to(dtype)
        if inner == "cg":
            e, it, _ = _pcg_fused(h, bp, inner_maxiter, inner_tol, cycle)
        else:
            e, it, _ = _solve_fused(h, bp, inner_maxiter, inner_tol, cycle, True)
        inner_iters.append(it)
        x64 = x64 + scale * e.to(torch.float64)
        r64 = b64 - fit_len(mat_vec(A64, x64), b64.shape[0])
        history.append(float(torch.linalg.norm(r64)))
    if stats is not None:
        stats["inner_iters"] = inner_iters
    xout = x64[:n] if return_device else x64[:n].cpu().numpy()
    return (xout, history) if log else xout
