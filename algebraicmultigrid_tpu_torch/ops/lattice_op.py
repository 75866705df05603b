"""Lat2D — gather-free device operator for lattice-structured levels.

The structured fast path (models/lattice.py) describes every level operator
by a small (offset × boundary-class) coefficient table on a 2-D grid.  On
device that becomes:

    y[ix, iy] = Σ_k  data_k[ix, iy] · X[base_x(ix) + dxₖ, base_y(iy) + dyₖ]

with ``base(i) = (i·p)//q`` per axis.  The per-axis ratio is 1, k or 1/k for
every operator the structured setup produces, so each offset k is ONE
(possibly strided or repeated) 2-D slice of the zero-padded input grid —
multiply-add on whole planes, no gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .sparse import round_up

__all__ = ["Lat2D", "lat2d_from_spec", "expand_planes", "lat2d_spmv", "pad_rows"]


def expand_planes(spec, dtype, device) -> torch.Tensor:
    """[n_off, Wx, Wy] planes from the class table: plane[k, i, j] =
    table[k, cx[i], cy[j]].  The (tiny) table is cast to the target dtype
    first, as the JAX package's expansion does, then indexed on the device:
    the selection copies table entries exactly."""
    cx, cy = spec.row_class_arrays()
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    T = torch.as_tensor(np.asarray(spec.table, dtype=np_dtype), device=device)
    ix = torch.as_tensor(cx, dtype=torch.long, device=device)
    iy = torch.as_tensor(cy, dtype=torch.long, device=device)
    return T[:, ix][:, :, iy].contiguous()


@dataclasses.dataclass(frozen=True)
class Lat2D:
    data: torch.Tensor  # [n_off, WxR, WyR]
    offsets: Tuple[Tuple[int, int], ...]
    row_dims: Tuple[int, int]
    col_dims: Tuple[int, int]
    base_x: Tuple[int, int]
    base_y: Tuple[int, int]
    shape: Tuple[int, int]
    nnz: int
    rows_padded: int

    @property
    def dtype(self):
        return self.data.dtype


def lat2d_from_spec(spec, dtype, device, row_pad: int) -> Lat2D:
    """Instantiate a device Lat2D from a host LatticeSpec."""
    WxR, WyR = spec.row_dims
    n_r = WxR * WyR
    return Lat2D(
        data=expand_planes(spec, dtype, device),
        offsets=tuple(tuple(int(v) for v in o) for o in spec.offsets),
        row_dims=(WxR, WyR),
        col_dims=tuple(spec.col_dims),
        base_x=tuple(spec.base_x),
        base_y=tuple(spec.base_y),
        shape=(n_r, spec.col_dims[0] * spec.col_dims[1]),
        nnz=spec.nnz(),
        rows_padded=round_up(max(n_r, 1), row_pad),
    )


def _axis_take(Xp, axis: int, d: int, m: int, W_row: int, base: Tuple[int, int], i0: int = 0):
    """Slice of the padded grid realising ``(i*p)//q + d`` along one axis
    for the rows ``i0 … i0 + W_row − 1``.  ``Xp`` is padded by ``m`` on
    each side of ``axis``; returns extent ``W_row`` along that axis."""
    p, q = base
    start = d + m
    if p == 1 and q == 1:
        return Xp.narrow(axis, start + i0, W_row)
    if p == 1:  # fine rows (prolongation): base = i//q — q rows share a source
        first = i0 // q
        src = (i0 + W_row - 1) // q - first + 1
        s = Xp.narrow(axis, start + first, src).repeat_interleave(q, dim=axis)
        return s.narrow(axis, i0 - first * q, W_row)
    if q == 1:  # coarse rows (restriction): base = p·i — strided read
        idx = [slice(None)] * Xp.dim()
        idx[axis] = slice(start + i0 * p, start + (i0 + W_row - 1) * p + 1, p)
        return Xp[tuple(idx)]
    raise ValueError(f"unsupported rational base {base}")


def pad_rows(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Zero-pad the leading (row) axis of a flat vector or an [n, k] block."""
    return torch.nn.functional.pad(v, (0, 0) * (v.dim() - 1) + (lo, hi))


def grid_first(x: torch.Tensor, n: int, dims) -> torch.Tensor:
    """The first n rows of a padded level vector (zero-extended when
    shorter) as the grid ``dims``; a multi-RHS block ``x[n, k]`` becomes
    [k, *dims], the right-hand sides leading."""
    x_log = x[:n] if x.shape[0] >= n else pad_rows(x, 0, n - x.shape[0])
    if x.dim() == 1:
        return x_log.reshape(dims)
    return x_log.T.reshape((x.shape[1],) + tuple(dims))


def grid_last(y: torch.Tensor, n: int, rows_padded: int, rhs: bool) -> torch.Tensor:
    """Inverse of :func:`grid_first` for an output grid of n cells: the
    flat (or, with ``rhs``, [rows, k]) level vector padded to
    ``rows_padded`` rows."""
    y = y.reshape(-1, n).T if rhs else y.reshape(n)
    return pad_rows(y, 0, rows_padded - n) if rows_padded > n else y


def lat2d_spmv(A: Lat2D, x: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """y = A·x for a flat (padded) x, or a multi-RHS block ``x[n, k]``;
    returns y of length rows_padded (by k).  ``row0`` makes ``A`` the block
    of grid rows ``row0 … row0 + row_dims[0] − 1`` of a taller operator
    (``data`` and ``row_dims`` the block's; the sharded tier's row block),
    x the operator's whole input."""
    WxR, WyR = A.row_dims
    WxC, WyC = A.col_dims
    X = grid_first(x, WxC * WyC, (WxC, WyC))  # [(k,) WxC, WyC]
    ax, ay = X.dim() - 2, X.dim() - 1
    mx = max((abs(dx) for dx, _ in A.offsets), default=0)
    my = max((abs(dy) for _, dy in A.offsets), default=0)
    Xp = torch.nn.functional.pad(X, (my, my, mx, mx))

    y = torch.zeros(X.shape[:-2] + (WxR, WyR), dtype=torch.promote_types(A.data.dtype, x.dtype), device=x.device)
    for k, (dx, dy) in enumerate(A.offsets):
        g = _axis_take(Xp, ax, dx, mx, WxR, A.base_x, row0)
        g = _axis_take(g, ay, dy, my, WyR, A.base_y)
        y = y + A.data[k] * g
    return grid_last(y, WxR * WyR, A.rows_padded, x.dim() == 2)
