"""Carry a device hierarchy across from numpy arrays.

``hierarchy_from_numpy`` builds the port's :class:`DeviceHierarchy` from the
arrays of another engine's hierarchy (for example the JAX package's
``DeviceHierarchy``, read out as numpy), so both engines can run on identical
operators.  The input is plain data:

* ``levels``: one dict per level with
  - ``"A"``, ``"P"``, ``"R"``: operator dicts whose ``"format"`` names the
    format (no ``"format"`` means Lat2D), with the fields of the port's
    class of that name:
    - ``Lat2D``: ``data`` [n_off, Wx, Wy] plus the static ``offsets``,
      ``row_dims``, ``col_dims``, ``base_x``, ``base_y``, ``shape``,
      ``nnz``, ``rows_padded``;
    - ``LatND``: ``data`` [n_off, *row_dims] plus ``offsets``,
      ``row_dims``, ``col_dims``, ``bases``, ``shape``, ``nnz``,
      ``rows_padded``;
    - ``ELL``: ``data``, ``cols`` [rows_padded, width], ``shape``, ``nnz``;
    - ``SDIA``: ``data`` [n_off, rows_padded], ``offsets``, ``p``, ``q``,
      ``shape``, ``nnz``, ``rows_padded``;
    - ``DenseOp``: ``mat``, ``shape``, ``nnz``, ``rows_padded``;
    - ``BTOp``: ``blocks``, ``rest_rows``, ``rest_data``, ``rest_cols``,
      ``deltas``, ``T``, ``C``, ``shape``, ``nnz``, ``rows_padded``;
    - ``BSG``: ``data``, ``off``, ``m0``, ``qlo``, ``shape``, ``nnz``,
      ``ws``, ``qb``, ``rows_padded``, ``cols_padded``;
  - ``"pre"``, ``"post"``: smoother dicts whose ``"kind"`` names the cache
    (no ``"kind"`` means masked multicolor), each with ``omega`` and
    ``iter`` and, but for Jacobi, ``forward`` and ``backward``:
    - ``MaskedMulticolorCache``: ``color_of``, ``dinv`` [rows_padded],
      ``n_colors``;
    - ``JacobiCache``: ``dinv``;
    - ``MulticolorCache``: ``rows``, ``data``, ``cols``, ``dinv`` (rows
      padded with the level's ``rows_padded``);
    - ``ScanGSCache``: ``diag``;
    - ``GSSweepCache`` (K5, a Lat2D level) and ``Sweep3DCache`` (K7, a 3-D
      LatND level): ``dinv`` [rows_padded], ``color_table`` (the periodic
      coloring's table, of the period shape), ``n_colors`` and optionally
      ``fallback``, the masked multicolor smoother dict that runs a
      multi-RHS x; the cache reads the level's own A;
  - ``"fused"``: None, or the legs' full-size planes ``A`` [nA, Wx, Wy]
    and ``dinv`` [Wx, Wy] with either the factored ``T``, ``S`` [Wx, Wy]
    or the non-factored ``R`` [nR, Wxc, Wyc] and ``P`` [nP, Wx, Wy] with
    their ``offsR``, ``offsP``, plus ``offsA``, ``color_grid``,
    ``n_colors``, ``k``, ``row_dims``, ``col_dims``, ``omega``, ``iter``,
    ``forward``, ``backward``;
* ``coarse``: ``kind`` ('qr' | 'pinv'), ``n``, ``rows_padded`` and the
  matrices ``qr_q``/``qr_r`` or ``mat``;
* optionally ``tail``: the whole-tail cache of ``levels[tail_start:]`` —
  ``"levels"``, one leg dict (as ``"fused"`` above) per tail level,
  fine to coarse, and ``"Mc"``, the [n7, n7] coarse solve operator;
* optionally ``sub``: the whole-subcycle cache of ``levels[sub_start:]`` —
  the factored-leg dict of level ``sub_start`` (as ``"fused"`` above); its
  deeper levels are the tail, which must start at ``sub_start + 1``;
* optionally ``final_A`` (an operator dict) and ``perm0``/``iperm0``, the
  fine level's RCM basis (index vectors of the fine level's padded length).

bf16 coefficient planes: numpy has no bf16 dtype that ``torch.as_tensor``
reads, so they travel as float32 arrays holding bf16 values, and
``coef_dtype=torch.bfloat16`` rounds them on arrival (exactly, for such
values): the ``"fused"`` planes A, dinv, T and S (or R and P), the tail
levels' A, T and S (or P; their dinv, R and ``Mc`` stay at ``dtype``) and,
under float32 only,
the LatND operators' planes, as ``build_device_hierarchy(...,
coef_dtype=torch.bfloat16)`` stores them under float32 or float64 vectors;
a ``sub`` cache's A, T and S as the tail's (its dinv at ``dtype``).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.device import (
    CoarseCache,
    DeviceHierarchy,
    DeviceLevel,
    JacobiCache,
    MaskedMulticolorCache,
    multicolor_cache,
)
from .ops.banded import SDIA, DenseOp, bt_op
from .ops.bsg import bsg_op
from .ops.kernels.gs_sweep import build_gs_sweep_cache
from .ops.kernels.scan_gs import scan_gs_cache
from .ops.kernels.subcycle_kernel import make_fused_subcycle_cache
from .ops.kernels.sweep3d import build_sweep3d_cache
from .ops.kernels.tail_kernel import make_fused_tail_cache
from .ops.kernels.vcycle_legs import FusedLegCache, coef_dtype_of, round_planes, with_tile_plans
from .ops.lattice_nd_op import LatND
from .ops.lattice_op import Lat2D
from .ops.sparse import ELL

__all__ = ["hierarchy_from_numpy", "slab_hierarchy_from_numpy"]


def _pairs(v):
    return tuple(tuple(int(a) for a in o) for o in v)


def _ints(v):
    return tuple(int(a) for a in v)


def _tensor(v, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(v), device=device).to(dtype).contiguous()


def _lat2d(d, dtype, device) -> Lat2D:
    return Lat2D(
        data=_tensor(d["data"], dtype, device),
        offsets=_pairs(d["offsets"]),
        row_dims=_ints(d["row_dims"]),
        col_dims=_ints(d["col_dims"]),
        base_x=_ints(d["base_x"]),
        base_y=_ints(d["base_y"]),
        shape=_ints(d["shape"]),
        nnz=int(d["nnz"]),
        rows_padded=int(d["rows_padded"]),
    )


def _op(d, dtype, device, nd_coef=None):
    """An operator from its dict; a LatND's planes in ``nd_coef`` (bf16)
    where given."""
    fmt = d.get("format", "Lat2D")
    if fmt == "Lat2D":
        return _lat2d(d, dtype, device)
    if fmt == "LatND":
        return LatND(
            data=_tensor(d["data"], nd_coef or dtype, device), offsets=_pairs(d["offsets"]),
            row_dims=_ints(d["row_dims"]), col_dims=_ints(d["col_dims"]), bases=_pairs(d["bases"]),
            shape=_ints(d["shape"]), nnz=int(d["nnz"]), rows_padded=int(d["rows_padded"]),
            vec_dtype=None if nd_coef is None else dtype,
        )
    if fmt == "ELL":
        return ELL(
            data=_tensor(d["data"], dtype, device), cols=_tensor(d["cols"], torch.int64, device),
            shape=_ints(d["shape"]), nnz=int(d["nnz"]),
        )
    if fmt == "SDIA":
        return SDIA(
            data=_tensor(d["data"], dtype, device), offsets=_ints(d["offsets"]), p=int(d["p"]),
            q=int(d["q"]), shape=_ints(d["shape"]), nnz=int(d["nnz"]), rows_padded=int(d["rows_padded"]),
        )
    if fmt == "DenseOp":
        return DenseOp(
            mat=_tensor(d["mat"], dtype, device), shape=_ints(d["shape"]), nnz=int(d["nnz"]),
            rows_padded=int(d["rows_padded"]),
        )
    if fmt == "BTOp":
        return bt_op(d, dtype, device)
    if fmt == "BSG":
        return bsg_op(dict(d, data=np.asarray(d["data"], dtype=np.float32)), device)
    raise ValueError(f"unknown operator format {fmt!r}")


_SWEEP_KINDS = {"GSSweepCache": build_gs_sweep_cache, "Sweep3DCache": build_sweep3d_cache}


def _smoother(d, dtype, device, A):
    kind = d.get("kind", "MaskedMulticolorCache")
    omega, iters = float(d["omega"]), int(d["iter"])
    if kind == "JacobiCache":
        return JacobiCache(dinv=_tensor(d["dinv"], dtype, device), omega=omega, iter=iters)
    fwd, bwd = bool(d["forward"]), bool(d["backward"])
    if kind == "MaskedMulticolorCache":
        return MaskedMulticolorCache(
            color_of=_tensor(d["color_of"], torch.int32, device), dinv=_tensor(d["dinv"], dtype, device),
            n_colors=int(d["n_colors"]), omega=omega, iter=iters, forward=fwd, backward=bwd,
        )
    if kind == "MulticolorCache":
        return multicolor_cache(
            d["rows"], d["data"], d["cols"], d["dinv"], int(d["rows_padded"]), dtype, device,
            omega, iters, fwd, bwd,
        )
    if kind == "ScanGSCache":
        return scan_gs_cache(A, _tensor(d["diag"], dtype, device), omega, iters, fwd, bwd)
    if kind in _SWEEP_KINDS:
        fallback = _smoother(d["fallback"], dtype, device, A) if d.get("fallback") is not None else None
        cache = _SWEEP_KINDS[kind](
            A, _tensor(d["dinv"], dtype, device), d["color_table"], int(d["n_colors"]), omega, iters, fwd, bwd,
            fallback,
        )
        if cache is None:
            raise ValueError(f"the level {A.row_dims} is past the {kind} kernel's shape limits")
        return cache
    raise ValueError(f"unknown smoother cache {kind!r}")


def _fused(d, dtype, device, coef_dtype=None, dinv=True):
    """A leg cache from its dict (factored with ``T``/``S``, else ``R``/``P``);
    with ``coef_dtype`` its planes rounded (``round_planes``; a tail level,
    ``dinv=False``, keeps D⁻¹ and R)."""
    if d is None:
        return None
    plane = lambda name: None if d.get(name) is None else _tensor(d[name], dtype, device)
    factored = d.get("T") is not None
    cache = with_tile_plans(FusedLegCache(
        A=_tensor(d["A"], dtype, device),
        dinv=_tensor(d["dinv"], dtype, device),
        T=plane("T"),
        S=plane("S"),
        R=None if factored else plane("R"),
        P=None if factored else plane("P"),
        offsR=() if factored else _pairs(d["offsR"]),
        offsP=() if factored else _pairs(d["offsP"]),
        offsA=_pairs(d["offsA"]),
        color_grid=_pairs(d["color_grid"]),
        n_colors=int(d["n_colors"]),
        k=int(d["k"]),
        row_dims=_ints(d["row_dims"]),
        col_dims=_ints(d["col_dims"]),
        omega=float(d["omega"]),
        iter=int(d["iter"]),
        forward=bool(d["forward"]),
        backward=bool(d["backward"]),
    ))
    return cache if coef_dtype is None else round_planes(cache, coef_dtype, dinv=dinv, restriction=dinv)


def hierarchy_from_numpy(
    levels, coarse, *, device, dtype, tail=None, tail_start: int = -1, final_A=None,
    perm0=None, iperm0=None, sub=None, sub_start: int = -1, coef_dtype=None,
) -> DeviceHierarchy:
    """Build the port's hierarchy from numpy arrays (see module docstring)."""
    device = torch.device(device)
    coef_dtype = coef_dtype_of(coef_dtype, dtype)
    nd_coef = coef_dtype if dtype == torch.float32 else None
    out = []
    for L in levels:
        A = _op(L["A"], dtype, device, nd_coef)
        out.append(DeviceLevel(
            A=A,
            P=_op(L["P"], dtype, device, nd_coef),
            R=_op(L["R"], dtype, device, nd_coef),
            pre=_smoother(L["pre"], dtype, device, A),
            post=_smoother(L["post"], dtype, device, A),
            fused=_fused(L.get("fused"), dtype, device, coef_dtype),
        ))
    out = tuple(out)
    empty = torch.zeros((0, 0), dtype=dtype, device=device)

    def mat(name):
        v = coarse.get(name)
        if v is None or np.asarray(v).size == 0:
            return empty
        return _tensor(v, dtype, device)

    cc = CoarseCache(
        mat=mat("mat"),
        qr_q=mat("qr_q"),
        qr_r=mat("qr_r"),
        kind=str(coarse["kind"]),
        n=int(coarse["n"]),
        rows_padded=int(coarse["rows_padded"]),
    )
    tail_cache = None
    if tail is not None:
        if not 0 <= tail_start < len(out):
            raise ValueError(f"tail_start {tail_start} is not a level of the hierarchy")
        tail_cache = make_fused_tail_cache(
            [_fused(d, dtype, device, coef_dtype, dinv=False) for d in tail["levels"]],
            _tensor(tail["Mc"], dtype, device),
        )
    else:
        tail_start = -1
    sub_cache = None
    if sub is not None:
        if tail_cache is None or sub_start + 1 != tail_start:
            raise ValueError(f"sub_start {sub_start} is not the level above the tail ({tail_start})")
        sub_cache = make_fused_subcycle_cache(_fused(sub, dtype, device, coef_dtype, dinv=False), tail_cache)
    else:
        sub_start = -1
    perms = [None if v is None else _tensor(v, torch.int64, device) for v in (perm0, iperm0)]
    return DeviceHierarchy(
        levels=out, coarse=cc, final_A=None if final_A is None else _op(final_A, dtype, device, nd_coef),
        tail=tail_cache, tail_start=tail_start, sub=sub_cache, sub_start=sub_start,
        perm0=perms[0], iperm0=perms[1],
    )


def _program(sm):
    """A slab smoother program: ("gs", color steps, ω) or ("jacobi", n, ω)."""
    kind, prog, omega = sm
    return (str(kind), tuple(int(c) for c in prog) if kind == "gs" else int(prog), float(omega))


def slab_hierarchy_from_numpy(levels, pinv, ctrue, cpad, n_sh: int, *, rank: int, device, dtype=None):
    """One rank's slab hierarchy (``parallel.lattice_cycle.SlabHierarchy``
    placed with ``to_rank``) from another engine's arrays, for example the
    JAX package's ``SlabHierarchy`` read out as numpy:

    * ``levels``: one dict per level with the slab arrays ``A``
      [n_sh, loc+2Hp, Wyp, n_off] (replicated levels [1, Wxp, Wyp, n_off]),
      ``dinv``, ``T``, ``S`` (the same without the offset axis) and the
      static ``offsets``, ``color_tab``, ``pre_sm``, ``post_sm``
      (``("gs", steps, ω)`` or ``("jacobi", n, ω)``), ``k``, ``dims``,
      ``pdims``, ``Hp``, ``sharded``;
    * ``pinv``, the dense coarse-solve operator; ``ctrue``/``cpad``, the
      true and padded coarsest grid; ``n_sh``, the number of slabs.

    ``dtype`` casts the arrays (None keeps theirs)."""
    from .parallel.lattice_cycle import SlabHierarchy, SlabLevel

    lvls = tuple(
        SlabLevel(
            A=np.asarray(d["A"]), dinv=np.asarray(d["dinv"]), T=np.asarray(d["T"]), S=np.asarray(d["S"]),
            offsets=_pairs(d["offsets"]), color_tab=tuple(tuple(int(c) for c in row) for row in d["color_tab"]),
            pre_sm=_program(d["pre_sm"]), post_sm=_program(d["post_sm"]), k=int(d["k"]), dims=_ints(d["dims"]),
            pdims=_ints(d["pdims"]), Hp=int(d["Hp"]), sharded=bool(d["sharded"]),
        )
        for d in levels
    )
    h = SlabHierarchy(levels=lvls, pinv=np.asarray(pinv), ctrue=_ints(ctrue), cpad=_ints(cpad), n_sh=int(n_sh))
    return h.to_rank(rank, device, dtype)
