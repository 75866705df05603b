"""Row blocks of the generic sharded tier: a level operator or smoother
held as this rank's rows, with every level vector whole on every rank.

The JAX package shards a level's arrays by rows and lets XLA insert the
collectives; here they are explicit.  A sharded SpMV computes this rank's
rows of ``A·x`` from the whole x with the format's own arithmetic (so each
row is computed as the single-device SpMV computes it) and all-gathers the
rows (the all-gather XLA inserts).  A sharded smoother step computes this
rank's rows of the update and all-gathers them.  ``ops/banded.mat_vec`` and
``models/device._apply_smoother`` dispatch here, so the single-device
cycle, solve loop and PCG run a sharded hierarchy unchanged: every rank
holds the same vectors and computes the same norms and dot products.

Blocks: ELL and Dense by rows of ``rows_padded`` (``[lo, hi)``), SDIA on
its row axis, Lat2D and LatND on the leading grid axis (``row0``, the
block's first grid row; its rows of the level vector are
``[row0·stride, (row0 + rows)·stride)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ..ops.banded import SDIA, DenseOp, mat_vec
from ..ops.lattice_nd_op import LatND, latnd_spmv
from ..ops.lattice_op import Lat2D, lat2d_spmv, pad_rows
from ..ops.sparse import ELL
from ..ops.spmv import ell_spmv
from .dist import RowMesh
from .lattice_cycle import _all_gather_rows

__all__ = ["ShardedOp", "ShardedSmoother", "shard_op", "shard_smoother", "sharded_mat_vec", "sharded_smooth"]


@dataclasses.dataclass(frozen=True)
class ShardedOp:
    """This rank's row block of a level operator: ``local`` is the format
    holding only the block's data; ``[lo, hi)`` its rows of the level
    vector; ``row0`` the block's first grid row (Lat2D, LatND) or row."""

    local: Any
    lo: int
    hi: int
    row0: int
    shape: Tuple[int, int]
    nnz: int
    rows_padded: int
    mesh: RowMesh

    @property
    def dtype(self):
        return self.local.dtype


@dataclasses.dataclass(frozen=True)
class ShardedSmoother:
    """A Jacobi, masked multicolor or natural-order GS cache holding this
    rank's rows ``[lo, hi)`` of its per-row arrays."""

    cache: Any
    lo: int
    hi: int
    mesh: RowMesh


def _block(n: int, mesh: RowMesh) -> Tuple[int, int]:
    loc = n // mesh.n_sh
    return mesh.rank * loc, (mesh.rank + 1) * loc


def shard_op(E, mesh: RowMesh):
    """This rank's row block of ``E`` (a copy: the rank keeps no other
    rows), or ``E`` itself where the format is held whole (BSG, BT, and a
    lattice whose leading axis does not split evenly)."""
    n_sh = mesh.n_sh
    if isinstance(E, (Lat2D, LatND)):
        W = E.row_dims[0]
        if W % n_sh:
            return E
        rows = W // n_sh
        row0 = mesh.rank * rows
        stride = int(np.prod(E.row_dims[1:]))
        local = dataclasses.replace(
            E, data=E.data[:, row0 : row0 + rows].clone(), row_dims=(rows,) + tuple(E.row_dims[1:]),
            shape=(rows * stride, E.shape[1]), rows_padded=rows * stride,
        )
        lo = row0 * stride
        return ShardedOp(local, lo, lo + rows * stride, row0, E.shape, E.nnz, E.rows_padded, mesh)
    if isinstance(E, (ELL, SDIA, DenseOp)):
        lo, hi = _block(E.rows_padded, mesh)
        if isinstance(E, ELL):
            local = dataclasses.replace(E, data=E.data[lo:hi].clone(), cols=E.cols[lo:hi].clone(),
                                        shape=(hi - lo, E.shape[1]))
        elif isinstance(E, SDIA):
            local = dataclasses.replace(E, data=E.data[:, lo:hi].clone(), rows_padded=hi - lo)
        else:
            local = dataclasses.replace(E, mat=E.mat[lo:hi].clone(), shape=(hi - lo, E.shape[1]),
                                        rows_padded=hi - lo)
        return ShardedOp(local, lo, hi, lo, E.shape, E.nnz, E.rows_padded, mesh)
    return E


def shard_smoother(cache, mesh: RowMesh):
    """This rank's rows of a Jacobi, masked multicolor or natural-order GS
    cache (the last without its kernel layout, which holds the whole
    level); other caches (the gathered multicolor one) stay whole."""
    from ..models.device import JacobiCache, MaskedMulticolorCache
    from ..ops.kernels.scan_gs import ScanGSCache

    if isinstance(cache, JacobiCache):
        lo, hi = _block(cache.dinv.shape[0], mesh)
        return ShardedSmoother(dataclasses.replace(cache, dinv=cache.dinv[lo:hi].clone()), lo, hi, mesh)
    if isinstance(cache, MaskedMulticolorCache):
        lo, hi = _block(cache.dinv.shape[0], mesh)
        return ShardedSmoother(
            dataclasses.replace(cache, color_of=cache.color_of[lo:hi].clone(), dinv=cache.dinv[lo:hi].clone()),
            lo, hi, mesh,
        )
    if isinstance(cache, ScanGSCache):
        lo, hi = _block(cache.diag.shape[0], mesh)
        return ShardedSmoother(dataclasses.replace(cache, diag=cache.diag[lo:hi].clone(), split=None), lo, hi, mesh)
    return cache


# --------------------------------------------------------------------------
# evaluation
# --------------------------------------------------------------------------


def _sdia_rows(A: SDIA, x: torch.Tensor, lo: int) -> torch.Tensor:
    """Rows ``lo … lo + A.rows_padded − 1`` of the SDIA product, each as
    ``ops.banded._sdia_spmv`` computes it (the same terms in the same
    order, x read as zero outside its rows)."""
    p, q = A.p, A.q
    rows = A.data.shape[1]
    base = torch.div(torch.arange(lo, lo + rows, device=x.device) * p, q, rounding_mode="floor")
    lo_pad = max(0, -((lo * p) // q + min(A.offsets)))
    hi_pad = max(0, ((lo + rows - 1) * p) // q + max(A.offsets) + 1 - x.shape[0])
    xp = pad_rows(x, lo_pad, hi_pad) if lo_pad or hi_pad else x
    tail = tuple(x.shape[1:])
    y = torch.zeros((rows,) + tail, dtype=torch.promote_types(A.data.dtype, x.dtype), device=x.device)
    for k, off in enumerate(A.offsets):
        dk = A.data[k] if not tail else A.data[k].unsqueeze(-1)
        y = y + dk * xp[base + (off + lo_pad)]
    return y


def local_rows(op: ShardedOp, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows ``[op.lo, op.hi)`` of ``A·x`` from the whole x."""
    A = op.local
    if isinstance(A, Lat2D):
        return lat2d_spmv(A, x, op.row0)
    if isinstance(A, LatND):
        return latnd_spmv(A, x, op.row0)
    if isinstance(A, SDIA):
        return _sdia_rows(A, x, op.lo)
    if isinstance(A, DenseOp):
        return torch.matmul(A.mat, x[: A.shape[1]])
    if isinstance(A, ELL):
        return ell_spmv(A, x)
    raise TypeError(f"no row block of {type(A).__name__}")


def _whole(block: torch.Tensor, n: int, mesh: RowMesh) -> torch.Tensor:
    """Every rank's block, in rank order, at ``n`` rows."""
    y = _all_gather_rows(block, mesh)
    if y.shape[0] < n:
        y = pad_rows(y, 0, n - y.shape[0])
    return y


def sharded_mat_vec(op: ShardedOp, x: torch.Tensor) -> torch.Tensor:
    """y = A·x, whole on every rank: this rank's rows, then an all-gather."""
    return _whole(local_rows(op, x), op.rows_padded, op.mesh)


def _rows_of_product(A, x, lo: int, hi: int) -> torch.Tensor:
    """Rows ``[lo, hi)`` of A·x: the rank's own rows where A is blocked the
    same way, else the whole product's."""
    if isinstance(A, ShardedOp) and (A.lo, A.hi) == (lo, hi):
        return local_rows(A, x)
    y = mat_vec(A, x)
    if y.shape[0] < hi:
        y = pad_rows(y, 0, hi - y.shape[0])
    return y[lo:hi]


def sharded_smooth(sm: ShardedSmoother, A, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The smoother on whole vectors: each Jacobi or color step updates this
    rank's rows as the single-device step updates them (the same
    expression), then all-gathers them.  Natural-order GS is sequential:
    the level and the diagonal are gathered for the sweep, which every rank
    runs whole."""
    from ..models.device import JacobiCache, MaskedMulticolorCache, _rows
    from ..ops.coloring import color_steps
    from ..ops.kernels.scan_gs import ScanGSCache, scan_gs_cache, smooth_scan_gs

    c, lo, hi, mesh = sm.cache, sm.lo, sm.hi, sm.mesh
    n = x.shape[0]
    if isinstance(c, JacobiCache):
        dinv = _rows(c.dinv, x)
        for _ in range(c.iter):
            r = b[lo:hi] - _rows_of_product(A, x, lo, hi)
            x = _whole(x[lo:hi] + c.omega * dinv * r, n, mesh)
        return x
    if isinstance(c, MaskedMulticolorCache):
        dinv, color_of = _rows(c.dinv, x), _rows(c.color_of, x)
        for col in color_steps(c.n_colors, c.iter, c.forward, c.backward, c.omega):
            r = b[lo:hi] - _rows_of_product(A, x, lo, hi)
            xl = x[lo:hi]
            x = _whole(torch.where(color_of == col, xl + c.omega * dinv * r, xl), n, mesh)
        return x
    if isinstance(c, ScanGSCache):
        if not (isinstance(A, ShardedOp) and isinstance(A.local, ELL)):
            raise TypeError("a sharded natural-order GS level needs a sharded ELL operator")
        E = A.local
        whole = dataclasses.replace(E, data=_all_gather_rows(E.data, mesh), cols=_all_gather_rows(E.cols, mesh),
                                    shape=A.shape)
        full = scan_gs_cache(whole, _all_gather_rows(c.diag, mesh), c.omega, c.iter, c.forward, c.backward)
        return smooth_scan_gs(whole, full, x, b)
    raise TypeError(f"no sharded smoother for {type(c).__name__}")
