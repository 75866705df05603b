"""Gather-free device operator formats (SDIA, block-Toeplitz, dense) and the
``mat_vec`` dispatch over every device format.

AMG hierarchies on grid-like problems are banded where the work is: the
square levels have a handful of diagonals, and the transfer operators P
(n_f×n_c) and R (n_c×n_f) are *rationally strided* banded,
col ≈ (row·p)/q + offset with a handful of offsets.

:class:`SDIA` represents  y[i] = Σ_k data[k, i] · x[(i·p)//q + off_k]
with static (p, q, offsets).  Split by residue r = i mod q:
(i·p)//q = m·p + (r·p)//q, so each (offset, residue) pair is one strided
slice of x.  :class:`BTOp` holds periodic transfer maps as a few dense
blocks (one ``einsum``) plus a sparse boundary remainder (``index_add_``);
:class:`DenseOp` is one ``torch.matmul`` for small levels.  Anything
irregular goes to the BSG gather tier (``ops/bsg.py``) or to ELL
(``ops/sparse.py``).  The builders are the JAX package's, so both packages
lower a level to the same format with the same arrays.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .bsg import BSG
from .kernels.bsg_spmv import bsg_spmv
from .lattice_nd_op import LatND, latnd_spmv
from .lattice_op import Lat2D, lat2d_spmv, pad_rows
from .sparse import ELL, as_csr, np_dtype, round_up
from .spmv import ell_spmv

__all__ = [
    "SDIA", "DenseOp", "BTOp", "sdia_from_csr", "dense_from_csr", "bt_from_csr",
    "mat_vec", "op_nnz",
]


@dataclasses.dataclass(frozen=True)
class SDIA:
    """Rationally-strided diagonal matrix (see module docstring)."""

    data: torch.Tensor  # [n_offsets, rows_padded]
    offsets: Tuple[int, ...]
    p: int
    q: int
    shape: Tuple[int, int]
    nnz: int
    rows_padded: int

    @property
    def dtype(self):
        return self.data.dtype


@dataclasses.dataclass(frozen=True)
class DenseOp:
    """Dense operator for small levels — one matmul per apply."""

    mat: torch.Tensor  # [rows_padded, cols] (zero rows beyond shape[0])
    shape: Tuple[int, int]
    nnz: int
    rows_padded: int

    @property
    def dtype(self):
        return self.mat.dtype


@dataclasses.dataclass(frozen=True)
class BTOp:
    """Block-Toeplitz operator + sparse boundary remainder.

    Rows mT+r couple to columns (m+δ)C+c with coefficients B_δ[r, c]
    independent of m, so Y[m] = Σ_δ B_δ @ X2[m+δ] with X2 = x reshaped to
    [·, C]; grid-boundary rows that deviate are kept as a compacted sparse
    remainder."""

    blocks: torch.Tensor     # [n_delta, T, C]
    rest_rows: torch.Tensor  # int64 [m_rest]; rows_padded marks an unused slot
    rest_data: torch.Tensor  # [m_rest, w]
    rest_cols: torch.Tensor  # int64 [m_rest, w]
    deltas: Tuple[int, ...]
    T: int
    C: int
    shape: Tuple[int, int]
    nnz: int
    rows_padded: int

    @property
    def dtype(self):
        return self.blocks.dtype


# --------------------------------------------------------------------------
# builders (host)
# --------------------------------------------------------------------------


def _candidate_strides(nr: int, nc: int, max_q: int = 8):
    """Candidate rational slopes p/q ≈ nc/nr to probe during detection."""
    seen = []
    ratio = nc / nr
    for q in range(1, max_q + 1):
        p = max(1, round(ratio * q))
        f = Fraction(p, q)
        if (f.numerator, f.denominator) not in seen:
            seen.append((f.numerator, f.denominator))
    return seen


def sdia_from_csr(M, dtype: torch.dtype, device, row_pad: int = 8, max_offsets: int = 40,
                  max_overhead: float = 6.0) -> Optional[SDIA]:
    """SDIA operator of ``M``, or None if no candidate stride yields
    ≤ ``max_offsets`` distinct offsets with padding overhead
    (n_offsets·rows/nnz) ≤ ``max_overhead``."""
    M = as_csr(M)
    nr, nc = M.shape
    if nr == 0 or nc == 0 or M.nnz == 0:
        return None
    rows = np.repeat(np.arange(nr), np.diff(M.indptr))
    cols = M.indices

    best = None
    for p, q in _candidate_strides(nr, nc):
        offs = cols - (rows * p) // q
        uniq = np.unique(offs)
        if len(uniq) > max_offsets:
            continue
        if len(uniq) * nr / M.nnz > max_overhead:
            continue
        if best is None or len(uniq) < best[2]:
            best = (p, q, len(uniq), uniq, offs)
    if best is None:
        return None

    p, q, n_off, uniq, offs = best
    rows_padded = round_up(nr, int(np.lcm(max(row_pad, 1), q)))
    data = np.zeros((n_off, rows_padded), dtype=np_dtype(dtype))
    data[np.searchsorted(uniq, offs), rows] = M.data.astype(data.dtype)
    return SDIA(
        data=torch.as_tensor(data, device=device), offsets=tuple(int(o) for o in uniq.tolist()),
        p=int(p), q=int(q), shape=(nr, nc), nnz=int(M.nnz), rows_padded=int(rows_padded),
    )


def dense_from_csr(M, dtype: torch.dtype, device, row_pad: int = 8) -> DenseOp:
    M = as_csr(M)
    nr, nc = M.shape
    rows_padded = round_up(max(nr, 1), row_pad)
    mat = np.zeros((rows_padded, nc), dtype=np_dtype(dtype))
    mat[:nr] = M.toarray().astype(mat.dtype)
    return DenseOp(mat=torch.as_tensor(mat, device=device), shape=(nr, nc), nnz=int(M.nnz),
                   rows_padded=rows_padded)


def bt_arrays(M, dtype: np.dtype, row_pad: int = 8, max_T: int = 2048, max_deltas: int = 4,
              max_rest_frac: float = 0.15):
    """Detect an exact block-Toeplitz structure (period from the reduced
    row:col ratio, block coefficients sampled from a mid-domain block-row,
    deviations into the sparse remainder).  Returns a dict of the BTOp's
    numpy arrays and static fields, or None."""
    M = as_csr(M)
    nr, nc = M.shape
    if nr == 0 or nc == 0 or M.nnz == 0:
        return None
    g = int(np.gcd(nr, nc))
    T0, C0 = nr // g, nc // g
    if T0 > max_T or C0 > max_T or g < 4:
        return None
    # the shape-derived period may divide the true one: probe powers of two
    mult = 1
    while True:
        T, C = T0 * mult, C0 * mult
        if T > max_T or C > max_T or nr // T < 4:
            return None
        out = _bt_try(M, nr, nc, T, C, dtype, row_pad, max_deltas, max_rest_frac)
        if out is not None:
            return out
        mult *= 2


def _bt_try(M, nr, nc, T, C, dtype, row_pad, max_deltas, max_rest_frac):
    Mr = nr // T
    rows = np.repeat(np.arange(nr), np.diff(M.indptr))
    cols = M.indices
    m_blk = rows // T
    deltas_all = cols // C - m_blk
    dmin, dmax = int(deltas_all.min()), int(deltas_all.max())
    if dmax - dmin + 1 > max_deltas:
        return None
    deltas = tuple(range(dmin, dmax + 1))

    # block coefficients from a mid-domain block-row
    sel = m_blk == Mr // 2
    blocks = np.zeros((len(deltas), T, C), dtype=dtype)
    blocks[deltas_all[sel] - dmin, rows[sel] % T, cols[sel] % C] = M.data[sel].astype(dtype)

    # predicted operator, and the remainder = actual − predicted
    bd, br, bc = np.nonzero(blocks)
    bv = blocks[bd, br, bc]
    mm = np.arange(Mr)
    rows_p = (mm[:, None] * T + br[None, :]).ravel()
    cols_p = ((mm[:, None] + bd[None, :] + dmin) * C + bc[None, :]).ravel()
    vals_p = np.broadcast_to(bv[None, :], (Mr, bv.size)).ravel()
    ok = (cols_p >= 0) & (cols_p < nc)
    P_pred = sp.coo_matrix((vals_p[ok], (rows_p[ok], cols_p[ok])), shape=(nr, nc)).tocsr()
    rest = (M - P_pred).tocsr()
    rest.eliminate_zeros()
    if rest.nnz > max_rest_frac * M.nnz:
        return None

    rows_padded = round_up(nr, int(np.lcm(row_pad, T)))
    rcounts = np.diff(rest.indptr)
    nz_rows = np.flatnonzero(rcounts)
    m_rest = max(int(nz_rows.size), 1)
    w = max(int(rcounts.max()) if rcounts.size else 0, 1)
    rest_rows = np.full(m_rest, rows_padded, dtype=np.int32)
    rest_data = np.zeros((m_rest, w), dtype=dtype)
    rest_cols = np.zeros((m_rest, w), dtype=np.int32)
    for k, i in enumerate(nz_rows):
        lo, hi = rest.indptr[i], rest.indptr[i + 1]
        rest_rows[k] = i
        rest_data[k, : hi - lo] = rest.data[lo:hi].astype(dtype)
        rest_cols[k, : hi - lo] = rest.indices[lo:hi]
    return dict(
        blocks=blocks, rest_rows=rest_rows, rest_data=rest_data, rest_cols=rest_cols,
        deltas=deltas, T=T, C=C, shape=(nr, nc), nnz=int(M.nnz), rows_padded=rows_padded,
    )


def bt_from_csr(M, dtype: torch.dtype, device, row_pad: int = 8) -> Optional[BTOp]:
    """BTOp of ``M``, or None (see :func:`bt_arrays`)."""
    got = bt_arrays(M, np_dtype(dtype), row_pad)
    if got is None:
        return None
    return bt_op(got, dtype, device)


def bt_op(d, dtype: torch.dtype, device) -> BTOp:
    """BTOp from the dict of :func:`bt_arrays` (or the same fields of the
    JAX package's BTOp)."""
    return BTOp(
        blocks=torch.as_tensor(np.asarray(d["blocks"]), device=device).to(dtype),
        rest_rows=torch.as_tensor(np.asarray(d["rest_rows"]).astype(np.int64), device=device),
        rest_data=torch.as_tensor(np.asarray(d["rest_data"]), device=device).to(dtype),
        rest_cols=torch.as_tensor(np.asarray(d["rest_cols"]).astype(np.int64), device=device),
        deltas=tuple(int(v) for v in d["deltas"]),
        T=int(d["T"]), C=int(d["C"]), shape=tuple(int(v) for v in d["shape"]),
        nnz=int(d["nnz"]), rows_padded=int(d["rows_padded"]),
    )


# --------------------------------------------------------------------------
# evaluation
# --------------------------------------------------------------------------


def _sdia_spmv(A: SDIA, x: torch.Tensor) -> torch.Tensor:
    """Σ_k data[k] · x[(i·p)//q + off_k] by strided slices (x flat or a
    multi-RHS block [n, k])."""
    p, q = A.p, A.q
    Mq = A.rows_padded // q  # rows_padded is a multiple of q by construction
    consts = [[(r * p) // q + off for r in range(q)] for off in A.offsets]
    flat = [c for row in consts for c in row]
    lo = max(0, -min(flat))
    hi = max(0, (Mq - 1) * p + max(flat) + 1 - x.shape[0])
    xp = pad_rows(x, lo, hi) if lo or hi else x
    tail = tuple(x.shape[1:])

    y = torch.zeros((A.rows_padded,) + tail, dtype=torch.promote_types(A.data.dtype, x.dtype), device=x.device)
    for k in range(len(A.offsets)):
        parts = []
        for r in range(q):
            c = consts[k][r] + lo
            parts.append(xp[c : c + (Mq - 1) * p + 1 : p])
        # interleave residues: y_k[m·q + r] = parts[r][m]
        xk = parts[0] if q == 1 else torch.stack(parts, dim=1).reshape((Mq * q,) + tail)
        dk = A.data[k] if not tail else A.data[k].unsqueeze(-1)
        y = y + dk * xk
    return y


def _dense_spmv(A: DenseOp, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(A.mat, x[: A.shape[1]])


def _bt_spmv(A: BTOp, x: torch.Tensor) -> torch.Tensor:
    nc = A.shape[1]
    T, C = A.T, A.C
    Mr = A.rows_padded // T
    tail = tuple(x.shape[1:])
    # X2[m] = x[mC : (m+1)C]; block rows m+δ for m in [0, Mr) are needed
    need_lo = -min(min(A.deltas), 0)
    need_hi = max(Mr + max(A.deltas), nc // C) - nc // C
    x_log = x[:nc] if x.shape[0] >= nc else pad_rows(x, 0, nc - x.shape[0])
    Xp = pad_rows(x_log, need_lo * C, max(need_hi, 0) * C)
    X2 = Xp.reshape((-1, C) + tail)
    Xs = torch.stack([X2[need_lo + d : need_lo + d + Mr] for d in A.deltas], dim=1)
    if tail:
        y = torch.einsum("dtc,mdck->mtk", A.blocks, Xs).reshape((A.rows_padded,) + tail)
    else:
        y = torch.einsum("dtc,mdc->mt", A.blocks, Xs).reshape(A.rows_padded)
    # boundary remainder: a small gather, then an index_add_ whose unused
    # slots land on one extra row that is cut off
    rest = A.rest_data if not tail else A.rest_data.unsqueeze(-1)
    contrib = (rest * x_log[A.rest_cols]).sum(dim=1)
    y = torch.cat([y, y.new_zeros((1,) + tail)]).index_add_(0, A.rest_rows, contrib)
    return y[: A.rows_padded]


def mat_vec(A, x: torch.Tensor) -> torch.Tensor:
    """SpMV over the device operator formats: x flat, or a multi-RHS block
    ``x[n, k]`` (every format takes one, as in the JAX package); a rank's
    row block of the sharded tier (``parallel/rows.py``) computes its rows
    and all-gathers them."""
    if isinstance(A, Lat2D):
        return lat2d_spmv(A, x)
    if isinstance(A, LatND):
        return latnd_spmv(A, x)
    if isinstance(A, BSG):
        return bsg_spmv(A, x)
    if isinstance(A, SDIA):
        return _sdia_spmv(A, x)
    if isinstance(A, BTOp):
        return _bt_spmv(A, x)
    if isinstance(A, DenseOp):
        return _dense_spmv(A, x)
    if isinstance(A, ELL):
        return ell_spmv(A, x)
    from ..parallel.rows import ShardedOp, sharded_mat_vec

    if isinstance(A, ShardedOp):  # a rank's row block (the sharded tier)
        return sharded_mat_vec(A, x)
    raise TypeError(f"unknown device operator format {type(A).__name__}")


def op_nnz(A) -> int:
    return A.nnz
