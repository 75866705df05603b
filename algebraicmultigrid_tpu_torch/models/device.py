"""Device (PyTorch) solve engine for lattice hierarchies.

Port of the lattice subset of the JAX package's ``models/device.py``:

* every level's A/P/R is a :class:`~..ops.lattice_op.Lat2D` — gather-free
  plane arithmetic; level vectors stay padded to ``rows_padded`` end to end;
* smoothers are masked multicolor GS/SOR sweeps (one full SpMV + masked
  blend per color step) on the periodic lattice coloring;
* levels whose SA setup stashed the factored prolongator run the fused legs
  (``ops/kernels/vcycle_legs.py``): hand-written CUDA kernels on the card,
  their plain versions on the CPU;
* the trailing run of small such levels plus the coarse solve runs as one
  whole-tail V-cycle (``ops/kernels/tail_kernel.py``) in V-cycles; those
  levels build no legs, and W/F cycles run them through the masked sweeps;
* ``run_fixed_cycles`` runs the top level's cross-cycle updown leg once per
  cycle;
* the V/W/F recursion unrolls in Python over the level list, and the
  iteration loops are Python loops with one host read of the residual norm
  per iteration for the stopping test;
* the coarse solve is a dense QR triangular solve or a pinv matmul
  (coarse_solver.jl:9-16,66-81 semantics, incl. the singular path).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..config import BackwardSweep, Cycle, F, ForwardSweep, GaussSeidel, SOR, SymmetricSweep, V, W
from ..ops.banded import mat_vec
from ..ops.coloring import color_steps
from ..ops.kernels.tail_kernel import build_fused_tail_cache, fused_tail
from ..ops.kernels.vcycle_legs import build_level_legs, fused_down, fused_up, fused_updown
from ..ops.lattice_op import lat2d_from_spec
from ..ops.sparse import round_up
from .coarse import QRSolver
from .multilevel import MultiLevel

# every level's row space is padded to a multiple of this, as in the JAX
# package, so level vectors line up with its hierarchies
ROW_PAD = 8

__all__ = [
    "MaskedMulticolorCache",
    "CoarseCache",
    "DeviceLevel",
    "DeviceHierarchy",
    "build_device_hierarchy",
    "get_device_hierarchy",
    "run_fixed_cycles",
    "cg_device",
    "solve_refined",
]


# --------------------------------------------------------------------------
# containers
# --------------------------------------------------------------------------


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
    A: Any  # Lat2D
    P: Any
    R: Any
    pre: MaskedMulticolorCache
    post: MaskedMulticolorCache
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
    tail: Any = None     # FusedTailCache of levels[tail_start:] + coarse solve
    tail_start: int = -1

    @property
    def fine_padded(self) -> int:
        return self.levels[0].A.rows_padded


# --------------------------------------------------------------------------
# smoother application
# --------------------------------------------------------------------------


def fit_len(v: torch.Tensor, n: int) -> torch.Tensor:
    """Pad-or-slice the leading axis to exactly n."""
    m = v.shape[0]
    if m == n:
        return v
    if m > n:
        return v[:n]
    return torch.nn.functional.pad(v, (0, n - m))


def _smooth_masked_multicolor(cache: MaskedMulticolorCache, A, x, b):
    n = x.shape[0]
    for c in color_steps(cache.n_colors, cache.iter, cache.forward, cache.backward, cache.omega):
        r = b - fit_len(mat_vec(A, x), n)
        x = torch.where(cache.color_of == c, x + cache.omega * cache.dinv * r, x)
    return x


# --------------------------------------------------------------------------
# building the device hierarchy
# --------------------------------------------------------------------------


def _sweep_flags(config):
    if not (isinstance(config, (GaussSeidel, SOR)) and config.ordering == "multicolor"):
        raise TypeError(
            f"the torch engine runs multicolor GaussSeidel/SOR smoothers, got {config!r}"
        )
    omega = float(config.omega) if isinstance(config, SOR) else 1.0
    fwd = isinstance(config.sweep, (ForwardSweep, SymmetricSweep))
    bwd = isinstance(config.sweep, (BackwardSweep, SymmetricSweep))
    return omega, fwd, bwd


def _build_lattice_smoother_cache(config, A_lat, rows_padded, dtype, device):
    """O(boundary) smoother cache for a lattice level: periodic torus
    coloring + host diagonal expansion, no O(nnz) graph analysis."""
    from .lattice import lattice_coloring

    spec = A_lat.spec
    n = A_lat.shape[0]
    omega, fwd, bwd = _sweep_flags(config)
    got = lattice_coloring(spec)
    if got is None:
        raise ValueError("no periodic lattice coloring for this level")
    grid, n_colors = got
    a, b = grid.shape
    Wx, Wy = spec.row_dims
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    diag = spec.diagonal().astype(np_dtype)
    colors = grid[(np.arange(Wx) % a)[:, None], (np.arange(Wy) % b)[None, :]].ravel()
    active = diag != 0
    color_of = np.full(rows_padded, n_colors, dtype=np.int32)
    color_of[:n] = np.where(active, colors, n_colors)
    dinv = np.zeros(rows_padded, dtype=np_dtype)
    dinv[:n] = np.where(active, 1.0 / np.where(active, diag, 1), 0.0)
    return MaskedMulticolorCache(
        color_of=torch.as_tensor(color_of, device=device),
        dinv=torch.as_tensor(dinv, device=device),
        n_colors=int(n_colors),
        omega=omega,
        iter=config.iter,
        forward=fwd,
        backward=bwd,
    )


def _build_coarse_cache(ml: MultiLevel, dtype, device, rows_padded: int) -> CoarseCache:
    cs = ml.coarse_solver
    n = ml.final_A.shape[0]
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    zero = torch.zeros((0, 0), dtype=dtype, device=device)
    if isinstance(cs, QRSolver) and not cs._singular and cs.Q is not None:
        return CoarseCache(
            mat=zero,
            qr_q=torch.as_tensor(cs.Q.astype(np_dtype), device=device),
            qr_r=torch.as_tensor(cs.R.astype(np_dtype), device=device),
            kind="qr",
            n=n,
            rows_padded=rows_padded,
        )
    pinvA = cs.pinvA if getattr(cs, "pinvA", None) is not None else np.linalg.pinv(
        ml.final_A.toarray()
    )
    return CoarseCache(
        mat=torch.as_tensor(pinvA.astype(np_dtype), device=device),
        qr_q=zero,
        qr_r=zero,
        kind="pinv",
        n=n,
        rows_padded=rows_padded,
    )


def build_device_hierarchy(
    ml: MultiLevel, *, device, dtype, fused: bool = True, tail: bool = True,
    tail_max_rows: int = 250_000,
) -> DeviceHierarchy:
    """Lower a host lattice hierarchy to device tensors.

    Every level's A/P/R must be a ``LatticeMatrix`` (the structured setup's
    ``latticify_tail`` makes them so); anything else raises.  ``fused=False``
    skips the fused legs and runs every level through the unfused ops.
    ``tail`` builds the whole-tail cache from the first level (in order) at
    which the tail gate holds with at most ``tail_max_rows`` rows; the
    levels it covers build no legs.  The two keywords are the counterparts
    of the JAX package's ``AMG_PALLAS_TAIL`` and ``AMG_TAIL_MAX_ROWS``."""
    from .lattice import LatticeMatrix

    device = torch.device(device)
    if not ml.levels:
        raise ValueError("the torch engine needs at least one hierarchy level")
    for i, level in enumerate(ml.levels):
        for name in ("A", "P", "R"):
            if not isinstance(getattr(level, name), LatticeMatrix):
                raise TypeError(f"level {i} {name} is not a LatticeMatrix")

    pads = [round_up(max(level.A.shape[0], 1), ROW_PAD) for level in ml.levels]
    final_pad = round_up(max(ml.final_A.shape[0], 1), ROW_PAD)
    pads.append(final_pad)

    tail_cache, tail_start = None, -1
    if tail:
        for start in range(len(ml.levels)):
            tail_cache = build_fused_tail_cache(
                ml.levels, ml, start, dtype, device, max_rows=tail_max_rows
            )
            if tail_cache is not None:
                tail_start = start
                break

    out = []
    for i, level in enumerate(ml.levels):
        A_dev = lat2d_from_spec(level.A.spec, dtype, device, row_pad=ROW_PAD)
        P_dev = lat2d_from_spec(level.P.spec, dtype, device, row_pad=pads[i])
        R_dev = lat2d_from_spec(level.R.spec, dtype, device, row_pad=pads[i + 1])
        pre = _build_lattice_smoother_cache(level.presmoother_config, level.A, pads[i], dtype, device)
        post = _build_lattice_smoother_cache(level.postsmoother_config, level.A, pads[i], dtype, device)
        covered = tail_cache is not None and i >= tail_start
        legs = build_level_legs(level, dtype, device) if fused and not covered else None
        out.append(DeviceLevel(A=A_dev, P=P_dev, R=R_dev, pre=pre, post=post, fused=legs))

    coarse = _build_coarse_cache(ml, dtype, device, final_pad)
    return DeviceHierarchy(levels=tuple(out), coarse=coarse, tail=tail_cache, tail_start=tail_start)


# --------------------------------------------------------------------------
# cycling
# --------------------------------------------------------------------------


def _coarse_solve(coarse: CoarseCache, b):
    b_log = b[: coarse.n]
    if coarse.kind == "qr":
        y = coarse.qr_q.T @ b_log
        x = torch.linalg.solve_triangular(coarse.qr_r, y[:, None], upper=True)[:, 0]
    else:
        x = coarse.mat @ b_log
    return fit_len(x, coarse.rows_padded)


def _cycle(h: DeviceHierarchy, cycle: Cycle, x, b, lvl: int, x_zero: bool = False):
    """One cycle at level lvl — structure of multilevel.jl:214-239.

    ``x_zero`` marks x as the zero vector (coarse-level recursion always
    starts from the zero guess, multilevel.jl:225): the fused down leg then
    does not read x."""
    if h.tail is not None and lvl == h.tail_start and isinstance(cycle, V) and x.dim() == 1:
        # every level from here down plus the coarse solve, one call
        return fused_tail(h.tail, x, b, x_zero=x_zero)

    level = h.levels[lvl]
    n_here = x.shape[0]
    n_next = h.levels[lvl + 1].A.rows_padded if lvl + 1 < len(h.levels) else h.coarse.rows_padded

    if level.fused is not None:
        x, coarse_b = fused_down(level.fused, x, b, x_zero=x_zero)
        coarse_b = fit_len(coarse_b, n_next)
    else:
        x = _smooth_masked_multicolor(level.pre, level.A, x, b)
        res = b - fit_len(mat_vec(level.A, x), n_here)
        coarse_b = fit_len(mat_vec(level.R, res), n_next)

    if lvl == len(h.levels) - 1:
        coarse_x = _coarse_solve(h.coarse, coarse_b)
    else:
        coarse_x = _next(h, cycle, torch.zeros_like(coarse_b), coarse_b, lvl + 1, x_zero=True)

    if level.fused is not None:
        return fused_up(level.fused, x, b, coarse_x)
    x = x + fit_len(mat_vec(level.P, coarse_x), n_here)
    return _smooth_masked_multicolor(level.post, level.A, x, b)


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
    return _cycle(h, cycle, x, b, 0)


def _subsolve(h: DeviceHierarchy, coarse_b, lvl: int):
    """One V-cycle from zero on the sub-hierarchy below ``lvl − 1``."""
    if lvl >= len(h.levels):
        return _coarse_solve(h.coarse, coarse_b)
    return _cycle(h, V(), torch.zeros_like(coarse_b), coarse_b, lvl, x_zero=True)


def run_fixed_cycles(h: DeviceHierarchy, x, b, n_cycles: int):
    """``n_cycles`` V-cycles, the same math as iterating
    :func:`_one_iteration`.  When the top level has fused legs (and the tail
    does not start there), the loop is: the down leg once, then per cycle
    the sub-hierarchy's V-cycle and the cross-cycle ``fused_updown`` (up of
    this cycle and down of the next in one launch), and a last sub-cycle and
    up leg.  Its rounding differs from the iterated cycles by the deduped
    boundary step of the double sweep."""
    fused = h.levels[0].fused
    usable = (
        n_cycles >= 1
        and fused is not None
        and x.dim() == 1
        and not (h.tail is not None and h.tail_start == 0)
    )
    if not usable:
        for _ in range(n_cycles):
            x = _one_iteration(h, V(), x, b)
        return x

    n_next = h.levels[1].A.rows_padded if len(h.levels) > 1 else h.coarse.rows_padded
    xf, bc = fused_down(fused, x, b)
    for _ in range(n_cycles - 1):
        xc = _subsolve(h, fit_len(bc, n_next), 1)
        xf, bc = fused_updown(fused, xf, b, xc)
    xc = _subsolve(h, fit_len(bc, n_next), 1)
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


def get_device_hierarchy(ml: MultiLevel, device=None, dtype=None) -> DeviceHierarchy:
    """The device hierarchy the solve drivers use for (device, dtype),
    built on first use and cached on ``ml``."""
    device, dtype = _resolve(ml, device, dtype)
    key = ("torch-hierarchy", str(device), str(dtype))
    if key not in ml._device_cache:
        ml._device_cache[key] = build_device_hierarchy(ml, device=device, dtype=dtype)
    return ml._device_cache[key]


# --------------------------------------------------------------------------
# solve drivers
# --------------------------------------------------------------------------


def _solve_fused(h: DeviceHierarchy, b, maxiter, abstol, cycle, calculate_residual):
    """Stationary iteration (multilevel.jl:158-198 semantics); returns
    (x, iterations, ‖r‖)."""
    A = h.levels[0].A
    x = torch.zeros_like(b)
    normres = float(torch.linalg.norm(b))
    itr = 1
    while itr <= maxiter and (not calculate_residual or normres > abstol):
        x = _one_iteration(h, cycle, x, b)
        if calculate_residual:
            normres = float(torch.linalg.norm(b - fit_len(mat_vec(A, x), b.shape[0])))
        itr += 1
    return x, itr - 1, normres


def _pcg_fused(h: DeviceHierarchy, b, maxiter, abstol, cycle):
    """Preconditioned CG with one AMG cycle (zero initial guess, fixed,
    linear — preconditioner.jl:12-19 contract) per iteration.  Returns
    (x, iterations, ‖r‖)."""
    A = h.levels[0].A
    n_pad = b.shape[0]

    def M(r):
        return _one_iteration(h, cycle, torch.zeros_like(r), r)

    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    itr = 0
    normr = float(torch.linalg.norm(r))
    while itr < maxiter and normr > abstol:
        Ap = fit_len(mat_vec(A, p), n_pad)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        itr += 1
        normr = float(torch.linalg.norm(r))
    return x, itr, normr


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
):
    """AMG-preconditioned conjugate gradients on the device."""
    device, dtype = _resolve(ml, device, dtype)
    h = get_device_hierarchy(ml, device, dtype)
    b_arr = torch.as_tensor(np.asarray(b), device=device).to(dtype)
    n = b_arr.shape[0]
    bp = fit_len(b_arr, h.fine_padded)
    normb = float(torch.linalg.norm(b_arr))
    thresh = max(tol * normb, abstol)
    x, itr, normr = _pcg_fused(h, bp, maxiter, thresh, cycle)
    xout = x[:n].cpu().numpy()
    return (xout, int(itr), float(normr)) if log else xout


def _get_fine_f64(ml: MultiLevel, device):
    """f64 Lat2D of the fine level — the outer-residual carrier of
    :func:`solve_refined`."""
    key = ("torch-fine64", str(device))
    if key not in ml._device_cache:
        spec = ml.levels[0].A.spec
        ml._device_cache[key] = lat2d_from_spec(spec, torch.float64, device, row_pad=ROW_PAD)
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
):
    """Mixed-precision iterative refinement: float32 AMG inner solves under
    a float64 outer residual loop, all on the device:

        r = b − A·x            (f64, one SpMV per round)
        solve A·e ≈ r in f32   (AMG-PCG or V-cycles to ``inner_tol``)
        x ← x + e              (f64)

    Per round the host reads one scalar norm.  ``b`` may be a device tensor
    (skips the upload); ``return_device=True`` returns the f64 device
    solution.  ``stats``, when given, receives the inner iteration count of
    each round under ``"inner_iters"``."""
    device, dtype = _resolve(ml, device, dtype)
    h = get_device_hierarchy(ml, device, dtype)
    A64 = _get_fine_f64(ml, device)
    n = ml.levels[0].A.shape[0]
    b64 = torch.as_tensor(b, device=device).to(torch.float64) if isinstance(b, torch.Tensor) else (
        torch.as_tensor(np.asarray(b, dtype=np.float64), device=device)
    )
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
