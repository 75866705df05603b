"""Sharded lattice V-cycle: slab-partitioned multigrid with explicit halo
exchange, one process per slab.

Port of the JAX package's ``parallel/lattice_cycle.py``, applied to the
structured-SA lattice hierarchies:

* every fine level's coefficient planes and vectors are **x-slab sharded**
  over the ranks of the row mesh (``dist.make_row_mesh``); the y axis stays
  whole per rank.  Coefficient slabs carry their halo rows, baked in at
  build time (constants: no exchange ever touches them);
* all cross-slab data motion is **nearest-neighbour**: point-to-point
  messages of the edge rows a phase needs (``halo.exchange_rows``).  A
  smoother application exchanges ONCE, with a halo of ``n_steps·reach``
  rows, and over-computes the extended slab (halo erosion);
* transfers use the factored prolongator ``P = (I − diag(s)A)T``:
  restriction and prolongation are stride-k subsamples / upsamples that
  stay slab-aligned, because padded x-dims are chosen top-down as
  ``Wxp(l+1) = Wxp(l)/k`` with ``Wxp(0)`` a multiple of ``k·n_sh``;
* **coarse-grid agglomeration**: once a level's slab would be thinner than
  its halo (or slab alignment breaks), the hierarchy switches to
  replicated levels — one ``all_gather`` of the restricted residual at the
  boundary, then every rank runs the identical tail, ending in a replicated
  dense pinv solve (singular-safe).

The JAX package runs the slab cycle as plain XLA inside one ``shard_map``;
here it is plain torch ops inside each rank's process (SPMD): every rank
calls the same functions with its own slab and the collectives pair up.
The W and F recursions exchange a number of times that depends only on the
hierarchy, the same on every rank.  ``build_slab_hierarchy`` is host numpy
and gives the JAX package's arrays exactly (all slabs);
``SlabHierarchy.to_rank`` puts one rank's slabs on its device.
``solve_lattice_sharded`` wraps the cycle in PCG whose dot products are
``all_reduce`` sums, with one host read of ‖r‖ per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..config import BackwardSweep, ForwardSweep, GaussSeidel, Jacobi, SOR, SymmetricSweep
from ..models.multilevel import MultiLevel
from ..ops.coloring import color_steps
from .dist import RowMesh, make_row_mesh
from .halo import exchange_rows

__all__ = [
    "SlabLevel",
    "SlabHierarchy",
    "build_slab_hierarchy",
    "cycle_lattice_sharded",
    "matvec_lattice_sharded",
    "solve_lattice_sharded",
]


@dataclasses.dataclass(frozen=True)
class SlabLevel:
    # host (numpy): sharded → [n_sh, loc+2Hp, Wyp(, n_off)], replicated →
    # [1, Wxp, Wyp(, n_off)], as the JAX package builds them.  On a rank
    # (torch): A [n_off, rows, Wyp], dinv/T/S [rows, Wyp], rows = loc+2Hp
    # (sharded) or Wxp (replicated).
    A: Any
    dinv: Any
    T: Any
    S: Any
    offsets: Tuple[Tuple[int, int], ...]
    color_tab: Tuple[Tuple[int, ...], ...]
    # smoother programs: ("gs", color_steps, ω) or ("jacobi", n_iters, ω)
    pre_sm: Tuple
    post_sm: Tuple
    k: int
    dims: Tuple[int, int]   # true (Wx, Wy)
    pdims: Tuple[int, int]  # padded (Wxp, Wyp)
    Hp: int                 # baked plane halo
    sharded: bool

    @property
    def reach(self) -> int:
        return max(max(abs(d) for d, _ in self.offsets), max(abs(d) for _, d in self.offsets))


@dataclasses.dataclass(frozen=True)
class SlabHierarchy:
    levels: Tuple[SlabLevel, ...]
    pinv: Any                # replicated dense coarse-solve operator
    ctrue: Tuple[int, int]   # true coarsest grid
    cpad: Tuple[int, int]    # padded coarsest grid
    n_sh: int
    rank: Optional[int] = None  # None: host arrays of every slab; else this rank's tensors

    @property
    def fine_pdims(self):
        return self.levels[0].pdims

    @property
    def fine_dims(self):
        return self.levels[0].dims

    def to_rank(self, rank: int, device, dtype=None) -> "SlabHierarchy":
        """This rank's slabs (replicated levels whole) as tensors on
        ``device``, planes first: A [n_off, rows, Wyp]."""
        if self.rank is not None:
            raise ValueError("the hierarchy is already placed on a rank")
        if not 0 <= rank < self.n_sh:
            raise ValueError(f"rank {rank} of a {self.n_sh}-slab hierarchy")

        def put(a, lv, planes_first=False):
            a = np.asarray(a)[rank if lv.sharded else 0]
            if planes_first:
                a = np.moveaxis(a, -1, 0)
            t = torch.tensor(np.ascontiguousarray(a), device=device)  # a copy: the slab may be a read-only view
            return t if dtype is None else t.to(dtype)

        levels = tuple(
            dataclasses.replace(
                lv, A=put(lv.A, lv, planes_first=True), dinv=put(lv.dinv, lv), T=put(lv.T, lv), S=put(lv.S, lv)
            )
            for lv in self.levels
        )
        pinv = torch.tensor(np.asarray(self.pinv), device=device)
        return dataclasses.replace(self, levels=levels, pinv=pinv if dtype is None else pinv.to(dtype), rank=rank)


def _scale_plane(level, spec) -> Optional[np.ndarray]:
    """Expand the stashed prolongator-smoothing scale ω·D̃⁻¹ to a full
    (Wx, Wy) plane."""
    from ..models.lattice import axis_classes

    s_t = getattr(level, "psmooth_scale", None)
    Wx, Wy = spec.row_dims
    if s_t is None:
        return None
    if isinstance(s_t, tuple) and s_t and s_t[0] == "table":
        _, tbl, (Kx, sx, Ky, sy) = s_t
        cx = axis_classes(np.arange(Wx), Wx, Kx, sx)
        cy = axis_classes(np.arange(Wy), Wy, Ky, sy)
        return np.asarray(tbl, dtype=np.float64)[cx[:, None], cy[None, :]]
    v = np.asarray(s_t, dtype=np.float64)
    if v.size != Wx * Wy:
        return None
    return v.reshape(Wx, Wy)


def build_slab_hierarchy(ml: MultiLevel, n_sh: int, dtype="float32", min_loc: int = 8) -> SlabHierarchy:
    """Lower a structured-SA lattice hierarchy to slab-sharded plane form
    (host numpy, every slab; ``SlabHierarchy.to_rank`` places one).

    Requires every level to be a LatticeMatrix carrying the
    factored-prolongator stash (single-offset box-k tentative prolongator T
    plus the ω·D̃⁻¹ smoothing scale) — i.e. a ``structured_smoothed_aggregation``
    hierarchy with the reference-default Jacobi prolongator smoothing.
    """
    from ..models.lattice import LatticeMatrix, lattice_coloring

    dt = np.dtype(dtype)
    meta = []
    truncated_at = None  # level index folded into the dense coarse solve
    max_dense = 16384
    for li, level in enumerate(ml.levels):
        try:
            if not isinstance(level.A, LatticeMatrix):
                raise ValueError("build_slab_hierarchy needs lattice levels")
            spec = level.A.spec
            T_t = getattr(level, "T_tent", None)
            if not isinstance(T_t, LatticeMatrix):
                raise ValueError("level lacks the factored-prolongator stash")
            specT = T_t.spec
            base = specT.base_x
            if base != specT.base_y or base[0] != 1 or base[1] not in (2, 3):
                raise ValueError(f"unsupported transfer base {base}")
            k = base[1]
            got = lattice_coloring(spec)
            if got is None:
                raise ValueError("level not colorable by a periodic table")
            tab, n_colors = got

            def sm_program(cfg):
                """Static smoother program for one config (GS/SOR any
                sweep, or Jacobi) — the smoother protocol of
                smoother.jl:10-23,92-99,173-180 on the slab tier."""
                if isinstance(cfg, Jacobi):
                    return ("jacobi", int(cfg.iter), float(cfg.omega))
                if isinstance(cfg, (GaussSeidel, SOR)):
                    om = float(cfg.omega) if isinstance(cfg, SOR) else 1.0
                    fwd = isinstance(cfg.sweep, (ForwardSweep, SymmetricSweep))
                    bwd = isinstance(cfg.sweep, (BackwardSweep, SymmetricSweep))
                    return ("gs", color_steps(n_colors, cfg.iter, fwd, bwd, om), om)
                raise ValueError(f"unsupported slab smoother {cfg!r}")

            pre_sm = sm_program(level.presmoother_config)
            post_sm = sm_program(level.postsmoother_config)
            S_pl = _scale_plane(level, spec)
            if S_pl is None:
                raise ValueError("level lacks the prolongator-smoothing scale")
        except ValueError:
            # agglomerate early: a small non-lattice (or unfactorable) level
            # becomes the replicated dense coarse solve; bigger ones are a
            # hard error (a dense solve there would dominate)
            if meta and level.A.shape[0] <= max_dense:
                truncated_at = li
                break
            raise
        reach = max(
            max((abs(d) for d, _ in spec.offsets), default=1),
            max((abs(d) for _, d in spec.offsets), default=1),
        )

        def sm_len(sm):
            return sm[1] if sm[0] == "jacobi" else len(sm[1])

        Hp = max(sm_len(pre_sm), sm_len(post_sm)) * reach + 2 * reach + k
        meta.append(dict(
            level=level, spec=spec, specT=specT,
            idxT=specT.offsets.index((0, 0)), k=k, tab=tab,
            pre_sm=pre_sm, post_sm=post_sm, S_pl=S_pl, reach=reach, Hp=Hp,
        ))

    def pad(v, m):
        return -(-v // m) * m

    # padded dims + sharding decisions, top-down (see module docstring):
    # a sharded level requires Wxp % (k·n_sh) == 0 so its slabs are equal
    # AND its stride-k restriction/prolongation stay slab-aligned
    # (loc_c = loc/k exactly); a sharded child inherits Wxp(parent)/k.
    # Replicated levels always use their own k-multiple padding — transfers
    # adapt by zero re-padding (free on replicated grids).
    for li, m in enumerate(meta):
        Wx, Wy = m["spec"].row_dims
        k = m["k"]
        parent = meta[li - 1] if li else None
        if parent is not None and parent["sharded"]:
            Wxp_sh = parent["pdims"][0] // parent["k"]
        elif parent is None:
            Wxp_sh = pad(Wx, k * n_sh)
        else:
            Wxp_sh = -1  # replicated parent → this level can't shard
        Wyp = pad(Wy, k)
        sharded = (
            Wxp_sh > 0
            and Wxp_sh % (k * n_sh) == 0
            and Wxp_sh // n_sh >= max(min_loc, m["Hp"])
        )
        m["pdims"] = (Wxp_sh, Wyp) if sharded else (pad(Wx, k), Wyp)
        m["sharded"] = sharded

    levels = []
    for m in meta:
        spec, specT = m["spec"], m["specT"]
        Wx, Wy = spec.row_dims
        Wxp, Wyp = m["pdims"]
        Hp, sharded = m["Hp"], m["sharded"]
        loc = Wxp // n_sh

        def halo_slabs(plane):
            """[Wxp, Wyp] plane → baked-halo slabs (or [1, ...] replicated).
            Always copies: ``fit`` below reuses one scratch buffer."""
            if not sharded:
                return plane[None].copy()
            padp = np.zeros((Wxp + 2 * Hp, Wyp), plane.dtype)
            padp[Hp : Hp + Wxp] = plane
            win = np.lib.stride_tricks.sliding_window_view(padp, (loc + 2 * Hp, Wyp))[::loc, 0]
            return np.ascontiguousarray(win)

        n_off = len(spec.offsets)
        full = np.zeros((Wxp, Wyp), np.float64)

        def fit(raw):
            full[:] = 0.0
            full[:Wx, :Wy] = raw
            return full

        A_sl = np.stack(
            [halo_slabs(fit(spec.expand(kk, dtype=np.float64))) for kk in range(n_off)],
            axis=-1,
        )
        diag = spec.diagonal().reshape(Wx, Wy)
        dv = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 0.0)
        levels.append(SlabLevel(
            A=A_sl.astype(dt),
            dinv=halo_slabs(fit(dv)).astype(dt),
            T=halo_slabs(fit(specT.expand(m["idxT"], dtype=np.float64))).astype(dt),
            S=halo_slabs(fit(m["S_pl"])).astype(dt),
            offsets=tuple(tuple(int(v) for v in o) for o in spec.offsets),
            color_tab=tuple(tuple(int(c) for c in row) for row in np.asarray(m["tab"])),
            pre_sm=m["pre_sm"],
            post_sm=m["post_sm"],
            k=m["k"],
            dims=(Wx, Wy),
            pdims=(Wxp, Wyp),
            Hp=Hp,
            sharded=sharded,
        ))

    import scipy.sparse as sp

    if truncated_at is None:
        Af = ml.final_A
    else:
        Af = ml.levels[truncated_at].A.tocsr()
    Af = Af.toarray() if sp.issparse(Af) else np.asarray(Af)
    pinv = np.linalg.pinv(Af).astype(dt)
    kL = meta[-1]["k"]
    WxL, WyL = meta[-1]["pdims"]
    # true coarsest dims from the last kept T spec's column grid
    ctrue = tuple(int(v) for v in meta[-1]["specT"].col_dims)
    cpad = (pad(WxL, kL) // kL, pad(WyL, kL) // kL)
    return SlabHierarchy(levels=tuple(levels), pinv=pinv, ctrue=ctrue, cpad=cpad, n_sh=n_sh)


# --------------------------------------------------------------------------
# in-rank pieces (operate on this rank's slab; rows are the leading axis)
# --------------------------------------------------------------------------


def _pad_rows(X, lo, hi):
    return torch.nn.functional.pad(X, (0, 0, lo, hi))


def _exch(X, H, sharded, mesh: RowMesh):
    """Extend a local slab by H rows from each slab neighbour (zeros at the
    chain ends — open boundary).  Replicated levels just zero-pad (the
    domain boundary)."""
    if H == 0:
        return X
    if not sharded or mesh.n_sh == 1:
        return _pad_rows(X, H, H)
    from_above, from_below = exchange_rows(X[:H], X[X.shape[0] - H :], mesh)
    return torch.cat([from_above, X, from_below], dim=0)


def _plane(lv: SlabLevel, arr, H):
    """This rank's coefficient slab at halo H ≤ Hp (rows are the
    second-to-last axis: A [n_off, rows, Wyp], the others [rows, Wyp])."""
    if not lv.sharded:
        return _pad_rows(arr, H, H) if H else arr
    d = lv.Hp - H
    return arr[..., d : arr.shape[-2] - d, :] if d else arr


def _stencil(A_h, Xe, offsets):
    """Σ_k A_k ⊙ shift_k(X) on an extended slab.  x-shifts roll within the
    slab (wrap garbage lands in the eroding halo ring); y-shifts read a
    zero-padded margin."""
    my = max((abs(dy) for _, dy in offsets), default=0)
    rows, cols = Xe.shape
    Xp = torch.nn.functional.pad(Xe, (my, my))
    acc = None
    for kk, (dx, dy) in enumerate(offsets):
        src = Xp[:, my + dy : my + dy + cols]
        if dx:
            src = torch.roll(src, -dx, dims=0)
        term = A_h[kk] * src
        acc = term if acc is None else acc + term
    return acc


def _colors(lv: SlabLevel, rows: int, H: int, mesh: RowMesh, device):
    """Color ids for the extended slab's rows (global pattern, periodic)."""
    tab = torch.as_tensor(np.asarray(lv.color_tab), device=device)
    a, b = tab.shape
    Wyp = lv.pdims[1]
    if lv.sharded and mesh.n_sh > 1:
        row0 = mesh.rank * (lv.pdims[0] // mesh.n_sh) - H
    else:
        row0 = -H
    px = (torch.arange(rows, device=device)[:, None] + row0) % a
    py = torch.arange(Wyp, device=device)[None, :] % b
    return tab[px, py]


def _smooth(lv: SlabLevel, x, b, mesh, sm):
    """Masked multicolor GS/SOR or weighted Jacobi: ONE halo exchange of
    n_steps·reach rows, then over-computed sweeps on the extended slab."""
    kind, prog, omega = sm
    n_steps = prog if kind == "jacobi" else len(prog)
    H = n_steps * lv.reach
    Xe = _exch(x, H, lv.sharded, mesh)
    Be = _exch(b, H, lv.sharded, mesh)
    A_h = _plane(lv, lv.A, H)
    D_h = _plane(lv, lv.dinv, H)
    if kind == "jacobi":
        for _ in range(prog):
            rsum = _stencil(A_h, Xe, lv.offsets)
            Xe = Xe + omega * D_h * (Be - rsum)
        return Xe[H : Xe.shape[0] - H] if H else Xe
    col = _colors(lv, Xe.shape[0], H, mesh, Xe.device)
    for c in prog:
        rsum = _stencil(A_h, Xe, lv.offsets)
        upd = Xe + omega * D_h * (Be - rsum)
        Xe = torch.where(col == c, upd, Xe)
    return Xe[H : Xe.shape[0] - H] if H else Xe


def _restrict(lv: SlabLevel, x, b, mesh):
    """ts = T ⊙ (r − A(S⊙r)) with r = b − A·x (R = Tᵀ(I − A·diag(s)), the
    factored form); the caller box-sums it (slab-locally or after an
    agglomeration gather)."""
    H = 2 * lv.reach
    Xe = _exch(x, H, lv.sharded, mesh)
    Be = _exch(b, H, lv.sharded, mesh)
    A_h = _plane(lv, lv.A, H)
    S_h = _plane(lv, lv.S, H)
    T_h = _plane(lv, lv.T, H)
    r = Be - _stencil(A_h, Xe, lv.offsets)
    ts = T_h * (r - _stencil(A_h, S_h * r, lv.offsets))
    return ts[H : ts.shape[0] - H]


def _subsample(ts, k):
    """[rows, cols] → [rows//k, cols//k] stride-k box sum (rows, cols padded
    to multiples of k by the caller)."""
    rows, cols = ts.shape
    return ts.reshape(rows // k, k, cols // k, k).sum(dim=(1, 3))


def _fit_cols(g, cols):
    if g.shape[1] == cols:
        return g
    if g.shape[1] > cols:
        return g[:, :cols]
    return torch.nn.functional.pad(g, (0, cols - g.shape[1]))


def _fit_rows(g, rows):
    if g.shape[0] == rows:
        return g
    if g.shape[0] > rows:
        return g[:rows]
    return _pad_rows(g, 0, rows - g.shape[0])


def _prolong_corr(lv: SlabLevel, xc_ext):
    """corr = T⊙up − S⊙(A·(T⊙up)) on this level's slab, from the child's
    solution ``xc_ext`` already extended by ``Hc`` coarse rows (and at this
    level's y-padding/k columns).  P = (I − diag(s)A)T."""
    k = lv.k
    reach = lv.reach
    Hc = -(-reach // k) + 1
    # upsample: fine row f reads coarse row f//k; xc_ext rows span
    # [−Hc·k, loc+Hc·k) fine rows after repeat
    up = xc_ext.repeat_interleave(k, dim=0).repeat_interleave(k, dim=1)
    H = reach
    lo = k * Hc - H
    rows = (xc_ext.shape[0] - 2 * Hc) * k
    upH = _fit_cols(up[lo : lo + rows + 2 * H], lv.pdims[1])
    A_h = _plane(lv, lv.A, H)
    S_h = _plane(lv, lv.S, H)
    T_h = _plane(lv, lv.T, H)
    Tup = T_h * upH
    corr = Tup - S_h * _stencil(A_h, Tup, lv.offsets)
    return corr[H : corr.shape[0] - H]


def _coarse_solve(h: SlabHierarchy, bc_full):
    """Replicated dense pinv solve on the true coarsest grid
    (coarse_solver.jl:9-16 — singular-safe Moore-Penrose apply)."""
    cW, cH = h.ctrue
    flat = bc_full[:cW, :cH].reshape(cW * cH)
    xg = (h.pinv @ flat).reshape(cW, cH)
    return torch.nn.functional.pad(xg, (0, h.cpad[1] - cH, 0, h.cpad[0] - cW))


def _all_gather_rows(t, mesh: RowMesh):
    """Every rank's ``t`` stacked along rows in rank order (the JAX tiled
    ``all_gather``); gloo on a card goes through host memory."""
    import torch.distributed as dist

    src = t.cpu() if mesh.staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.n_sh)]
    work = dist.all_gather(parts, src, async_op=True)
    if mesh.backend == "gloo":
        work.wait(mesh.timeout)
    else:
        work.wait()
    return torch.cat(parts, dim=0).to(t.device)


def _child_cycles(h, li, x0, bc, mesh, cyc):
    """Recursion policy of multilevel.jl:200-212 applied to the child call:
    V → one cycle; W → two chained W cycles; F → an F cycle then a V."""
    xc = _level_cycle(h, li, x0, bc, mesh, cyc)
    if cyc == "w":
        xc = _level_cycle(h, li, xc, bc, mesh, "w")
    elif cyc == "f":
        xc = _level_cycle(h, li, xc, bc, mesh, "v")
    return xc


def _level_cycle(h: SlabHierarchy, li: int, x, b, mesh: RowMesh, cyc: str = "v"):
    """One cycle recursion step at level li on this rank's slabs."""
    lv = h.levels[li]
    k = lv.k
    n_sh = mesh.n_sh
    x = _smooth(lv, x, b, mesh, lv.pre_sm)
    ts = _restrict(lv, x, b, mesh)

    last = li + 1 >= len(h.levels)
    child = None if last else h.levels[li + 1]
    child_sharded = (child is not None) and child.sharded
    Hc = -(-lv.reach // k) + 1

    if child_sharded:
        # slab-local subsample: loc divides k by construction
        bc = _fit_cols(_subsample(ts, k), child.pdims[1])
        xc = _child_cycles(h, li + 1, torch.zeros_like(bc), bc, mesh, cyc)
        # child slabs already aligned: loc_c = loc/k; extend by Hc rows
        xc_ext = _exch(_fit_cols(xc, lv.pdims[1] // k), Hc, True, mesh)
    else:
        # agglomeration: gather ts to the full grid, subsample replicated
        ts_full = _all_gather_rows(ts, mesh) if lv.sharded and n_sh > 1 else ts
        rows = -(-ts_full.shape[0] // k) * k
        cols = -(-ts_full.shape[1] // k) * k
        bc_full = _subsample(_fit_rows(_fit_cols(ts_full, cols), rows), k)
        if last:
            xcf = _coarse_solve(h, bc_full)
        else:
            bc_full = _fit_rows(_fit_cols(bc_full, child.pdims[1]), child.pdims[0])
            xcf = _child_cycles(h, li + 1, torch.zeros_like(bc_full), bc_full, mesh, cyc)
        # slice this rank's coarse rows (+Hc halo) from the replicated grid
        nc_rows = lv.pdims[0] // k  # coarse rows aligned to this level
        xcf = _fit_rows(_fit_cols(xcf, lv.pdims[1] // k), nc_rows)
        padded = _pad_rows(xcf, Hc, Hc)
        if lv.sharded and n_sh > 1:
            loc_c = nc_rows // n_sh
            start = mesh.rank * loc_c
            xc_ext = padded[start : start + loc_c + 2 * Hc]
        else:
            xc_ext = padded

    x = x + _prolong_corr(lv, xc_ext)
    return _smooth(lv, x, b, mesh, lv.post_sm)


def _cycle_tag(cycle) -> str:
    name = type(cycle).__name__.lower() if not isinstance(cycle, str) else cycle.lower()
    if name not in ("v", "w", "f"):
        raise ValueError(f"unknown cycle {cycle!r}")
    return name


def _check_rank(h: SlabHierarchy, mesh: RowMesh):
    if h.rank is None:
        raise ValueError("place the hierarchy on this rank first (SlabHierarchy.to_rank)")
    if h.rank != mesh.rank or h.n_sh != mesh.n_sh:
        raise ValueError(f"a hierarchy of rank {h.rank} of {h.n_sh} on rank {mesh.rank} of {mesh.n_sh}")


def cycle_lattice_sharded(h: SlabHierarchy, x, b, mesh: RowMesh, cycle="v"):
    """One V/W/F cycle on this rank's slab of the padded fine grid
    ([loc, Wyp]; the whole [Wxp, Wyp] grid when the fine level is
    replicated).  Linear in (x, b); call with x = 0 for the preconditioner
    contract.  Recursion policy follows multilevel.jl:200-212 exactly."""
    _check_rank(h, mesh)
    return _level_cycle(h, 0, x, b, mesh, _cycle_tag(cycle))


def matvec_lattice_sharded(h: SlabHierarchy, x, mesh: RowMesh):
    """y = A₀·x on this rank's slab of the padded fine grid (the O(surface)
    exchange of ``halo.py`` and the slab stencil)."""
    _check_rank(h, mesh)
    lv = h.levels[0]
    reach = lv.reach
    Xe = _exch(x, reach, lv.sharded, mesh)
    y = _stencil(_plane(lv, lv.A, reach), Xe, lv.offsets)
    return y[reach : y.shape[0] - reach]


def _sum_all(v: torch.Tensor, mesh: RowMesh, sharded: bool) -> torch.Tensor:
    """Σ over the slabs of per-rank partial sums ``v`` (a replicated level's
    sums are already whole)."""
    if not sharded or mesh.n_sh == 1:
        return v
    import torch.distributed as dist

    src = v.cpu() if mesh.staged else v.clone()
    work = dist.all_reduce(src, async_op=True)
    if mesh.backend == "gloo":
        work.wait(mesh.timeout)
    else:
        work.wait()
    return src.to(v.device)


def slab_hierarchy(ml: MultiLevel, mesh: RowMesh, dtype="float32") -> SlabHierarchy:
    """This rank's slab hierarchy of ``ml``, built on first use and cached
    on ``ml``."""
    key = ("torch-slab", np.dtype(dtype).name, mesh.n_sh, mesh.rank, str(mesh.device))
    if key not in ml._device_cache:
        ml._device_cache[key] = build_slab_hierarchy(ml, mesh.n_sh, dtype=dtype).to_rank(mesh.rank, mesh.device)
    return ml._device_cache[key]


def solve_lattice_sharded(
    ml: MultiLevel,
    b,
    *,
    mesh: Optional[RowMesh] = None,
    tol: float = 1e-8,
    maxiter: int = 100,
    dtype="float32",
    log: bool = False,
    cycle="v",
    device=None,
):
    """AMG-PCG on the slab-sharded lattice hierarchy: the slab cycle as
    preconditioner, dot products summed over the ranks (``all_reduce``),
    one host read of ‖r‖ per iteration for the stopping test.  Every rank
    passes the full ``b`` and gets the full x (+ (iters, relres) with
    ``log=True``).  Without ``mesh`` it runs one slab in this process on
    ``device`` (default: the card)."""
    if mesh is None:
        mesh = make_row_mesh(device=device)
    h = slab_hierarchy(ml, mesh, dtype)
    Wx, Wy = h.fine_dims
    Wxp, Wyp = h.fine_pdims
    n = Wx * Wy
    dt = np.dtype(dtype)
    bg = np.zeros((Wxp, Wyp), dtype=dt)
    bg[:Wx, :Wy] = np.asarray(b, dtype=dt).reshape(Wx, Wy)
    lv0 = h.levels[0]
    sharded = lv0.sharded and mesh.n_sh > 1
    if sharded:
        loc = Wxp // mesh.n_sh
        bg = bg[mesh.rank * loc : (mesh.rank + 1) * loc]
    bl = torch.as_tensor(np.ascontiguousarray(bg), device=mesh.device)
    cyc = _cycle_tag(cycle)

    def M(r):
        return _level_cycle(h, 0, torch.zeros_like(r), r, mesh, cyc)

    def dots(*pairs):
        return _sum_all(torch.stack([torch.sum(u * v) for u, v in pairs]), mesh, sharded)

    normb = float(np.linalg.norm(np.asarray(b)))
    abstol = tol * normb
    x = torch.zeros_like(bl)
    r = bl
    z = M(r)
    p = z
    rz, nr2 = dots((r, z), (r, r))
    nr = float(torch.sqrt(nr2))
    it = 0
    while it < maxiter and nr > abstol:
        Ap = matvec_lattice_sharded(h, p, mesh)
        alpha = rz / dots((p, Ap))[0]
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz2, nr2 = dots((r, z), (r, r))
        p = z + (rz2 / rz) * p
        rz = rz2
        it += 1
        nr = float(torch.sqrt(nr2))
    xg = _all_gather_rows(x, mesh) if sharded else x
    xout = xg[:Wx, :Wy].reshape(n).cpu().numpy()
    if log:
        return xout, it, nr / max(normb, 1e-300)
    return xout
