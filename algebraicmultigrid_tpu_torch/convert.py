"""Carry a device hierarchy across from numpy arrays.

``hierarchy_from_numpy`` builds the port's :class:`DeviceHierarchy` from the
arrays of another engine's hierarchy (for example the JAX package's
``DeviceHierarchy``, read out as numpy), so both engines can run on identical
operators.  The input is plain data:

* ``levels``: one dict per level with
  - ``"A"``, ``"P"``, ``"R"``: Lat2D dicts — ``data`` [n_off, Wx, Wy] plus the
    static ``offsets``, ``row_dims``, ``col_dims``, ``base_x``, ``base_y``,
    ``shape``, ``nnz``, ``rows_padded``;
  - ``"pre"``, ``"post"``: masked multicolor smoother dicts — ``color_of``,
    ``dinv`` [rows_padded] plus ``n_colors``, ``omega``, ``iter``,
    ``forward``, ``backward``;
  - ``"fused"``: None, or the factored legs' full-size planes ``A``
    [nA, Wx, Wy], ``dinv``, ``T``, ``S`` [Wx, Wy] plus ``offsA``,
    ``color_grid``, ``n_colors``, ``k``, ``row_dims``, ``col_dims``,
    ``omega``, ``iter``, ``forward``, ``backward``;
* ``coarse``: ``kind`` ('qr' | 'pinv'), ``n``, ``rows_padded`` and the
  matrices ``qr_q``/``qr_r`` or ``mat``;
* optionally ``tail``: the whole-tail cache of ``levels[tail_start:]`` —
  ``"levels"``, one factored-leg dict (as ``"fused"`` above) per tail level,
  fine to coarse, and ``"Mc"``, the [n7, n7] coarse solve operator.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.device import CoarseCache, DeviceHierarchy, DeviceLevel, MaskedMulticolorCache
from .ops.kernels.tail_kernel import make_fused_tail_cache
from .ops.kernels.vcycle_legs import FusedLegCache
from .ops.lattice_op import Lat2D

__all__ = ["hierarchy_from_numpy"]


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


def _smoother(d, dtype, device) -> MaskedMulticolorCache:
    return MaskedMulticolorCache(
        color_of=_tensor(d["color_of"], torch.int32, device),
        dinv=_tensor(d["dinv"], dtype, device),
        n_colors=int(d["n_colors"]),
        omega=float(d["omega"]),
        iter=int(d["iter"]),
        forward=bool(d["forward"]),
        backward=bool(d["backward"]),
    )


def _fused(d, dtype, device):
    if d is None:
        return None

    return FusedLegCache(
        A=_tensor(d["A"], dtype, device),
        dinv=_tensor(d["dinv"], dtype, device),
        T=_tensor(d["T"], dtype, device),
        S=_tensor(d["S"], dtype, device),
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
    )


def hierarchy_from_numpy(levels, coarse, *, device, dtype, tail=None, tail_start: int = -1) -> DeviceHierarchy:
    """Build the port's hierarchy from numpy arrays (see module docstring)."""
    device = torch.device(device)
    out = tuple(
        DeviceLevel(
            A=_lat2d(L["A"], dtype, device),
            P=_lat2d(L["P"], dtype, device),
            R=_lat2d(L["R"], dtype, device),
            pre=_smoother(L["pre"], dtype, device),
            post=_smoother(L["post"], dtype, device),
            fused=_fused(L.get("fused"), dtype, device),
        )
        for L in levels
    )
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
            [_fused(d, dtype, device) for d in tail["levels"]], _tensor(tail["Mc"], dtype, device)
        )
    else:
        tail_start = -1
    return DeviceHierarchy(levels=out, coarse=cc, tail=tail_cache, tail_start=tail_start)
