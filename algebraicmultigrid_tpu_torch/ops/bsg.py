"""BSG — block-select-gather: the device format for UNSTRUCTURED matrices.

The reference solves arbitrary ``SparseMatrixCSC`` in every code path
(AlgebraicMultigrid.jl ``src/multilevel.jl:214-239``); the lattice, SDIA
and dense formats only cover structured or small operators.  BSG is the
JAX package's windowed-ELL layout for RCM-banded unstructured rows:

* rows are grouped into tiles of 1024 (8 × 128); the device hierarchy
  RCM-permutes unstructured levels so each tile's columns fit a window of
  ``ws`` consecutive 128-blocks of x starting at block ``m0[t]``;
* slot k of row ``t·1024 + u·128 + j`` stores its coefficient in
  ``data[t, k, u, j]`` and its column as the window offset
  ``off[t, k, u, j] = col − m0[t]·128`` (0 and 0 on padding slots).

So y[t·1024 + u·128 + j] = Σ_k data[t,k,u,j] · x[m0[t]·128 + off[t,k,u,j]].
The kernel that evaluates it (K6) is in ``ops/kernels/bsg_spmv.py``.  The
builder is the JAX package's, so both lower a level with the same arrays
(``qlo``/``qb`` only steer the TPU kernel's window sweep; they are kept so
the layouts compare), and it keeps its refusals: float32 only, rows denser
than ``K_cap``, windows wider than ``ws_cap`` blocks, and padded storage
above ``max_overhead`` × nnz return None.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .sparse import as_csr, np_dtype, round_up

__all__ = ["BSG", "bsg_arrays", "bsg_from_csr", "rcm_permutation", "LANES", "TILE_ROWS"]

LANES = 128
TILE_ROWS = 1024  # 8 × 128
_WS_CHOICES = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def rcm_permutation(A) -> np.ndarray:
    """Reverse-Cuthill-McKee ordering of the symmetrised pattern — the
    row/column order that minimises BSG window spans on mesh-like graphs."""
    M = as_csr(A)
    G = (M + M.T).tocsr() if M.shape[0] == M.shape[1] else M
    return np.asarray(sp.csgraph.reverse_cuthill_mckee(G, symmetric_mode=True), dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class BSG:
    """Block-select-gather operator: y = A·x in tiled windowed-ELL form."""

    data: torch.Tensor  # [T, K, 8, 128] slot coefficients (0 on padding)
    off: torch.Tensor   # int32 [T, K, 8, 128] window offsets (0 on padding)
    m0: torch.Tensor    # int32 [T] first x-block of each tile's window
    qlo: torch.Tensor   # int32 [T, K] first window block each slot touches
    shape: Tuple[int, int]
    nnz: int
    ws: int
    qb: int             # window blocks a slot's columns span, at most
    rows_padded: int
    cols_padded: int

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def n_tiles(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]


def bsg_arrays(A, dtype: np.dtype, ws_cap: int = 512, K_cap: int = 64, max_overhead: float = 24.0,
               row_pad: int = 8):
    """The BSG layout of a (pre-permuted) host sparse matrix as a dict of
    numpy arrays and static fields, or None when it refuses (see module
    docstring)."""
    dt = np.dtype(dtype)
    if dt.kind != "f" or dt.itemsize > 4:
        return None
    M = as_csr(A)
    n_rows, n_cols = M.shape
    if n_rows == 0 or M.nnz == 0:
        return None
    counts = np.diff(M.indptr)
    K = int(counts.max(initial=1))
    if K > K_cap:
        return None
    T = -(-n_rows // TILE_ROWS)
    if T * K * TILE_ROWS > max_overhead * max(M.nnz, 1):
        return None

    rows = np.repeat(np.arange(n_rows, dtype=np.int64), counts)
    cols = M.indices.astype(np.int64)
    tile_of = rows // TILE_ROWS
    u_of = (rows % TILE_ROWS) // LANES
    j_of = rows % LANES
    slot = np.arange(M.nnz, dtype=np.int64) - M.indptr[:-1].astype(np.int64)[rows]

    lo = np.full(T, np.iinfo(np.int64).max, dtype=np.int64)
    hi = np.zeros(T, dtype=np.int64)
    np.minimum.at(lo, tile_of, cols)
    np.maximum.at(hi, tile_of, cols)
    mask_empty = lo > hi
    lo[mask_empty], hi[mask_empty] = 0, 0
    # window starts aligned to 8 blocks, as the JAX package's TPU kernel needs
    m0 = (lo // LANES) // 8 * 8
    span = int((hi // LANES - m0 + 1).max(initial=1))
    ws = next((w for w in _WS_CHOICES if w >= span and w <= ws_cap), None)
    if ws is None:
        return None

    data = np.zeros((T, K, 8, LANES), dtype=dt)
    off = np.zeros((T, K, 8, LANES), dtype=np.int32)
    data[tile_of, slot, u_of, j_of] = M.data.astype(dt)
    off[tile_of, slot, u_of, j_of] = cols - m0[tile_of] * LANES

    # per-(tile, slot) block range of the columns
    ts_key = tile_of * K + slot
    qmin = np.full(T * K, np.iinfo(np.int64).max, dtype=np.int64)
    qmax = np.full(T * K, -1, dtype=np.int64)
    s_blk = cols // LANES - m0[tile_of]
    np.minimum.at(qmin, ts_key, s_blk)
    np.maximum.at(qmax, ts_key, s_blk)
    empty_ts = qmax < 0
    qmin[empty_ts], qmax[empty_ts] = 0, 0
    qb = int((qmax - qmin + 1).max(initial=1))
    qlo = np.minimum(qmin, ws - qb).astype(np.int32).reshape(T, K)

    return dict(
        data=data, off=off, m0=m0.astype(np.int32), qlo=qlo,
        shape=(n_rows, n_cols), nnz=int(M.nnz), ws=ws, qb=qb,
        rows_padded=max(round_up(n_rows, max(row_pad, 1)), row_pad),
        cols_padded=round_up(max(n_cols, 1), LANES),
    )


def bsg_op(d, device) -> BSG:
    """BSG from the dict of :func:`bsg_arrays` (or the same fields of the
    JAX package's BSG)."""
    return BSG(
        data=torch.as_tensor(np.array(d["data"]), device=device),
        off=torch.as_tensor(np.array(d["off"], dtype=np.int32), device=device),
        m0=torch.as_tensor(np.array(d["m0"], dtype=np.int32), device=device),
        qlo=torch.as_tensor(np.array(d["qlo"], dtype=np.int32), device=device),
        shape=tuple(int(v) for v in d["shape"]), nnz=int(d["nnz"]), ws=int(d["ws"]),
        qb=int(d["qb"]), rows_padded=int(d["rows_padded"]), cols_padded=int(d["cols_padded"]),
    )


def bsg_from_csr(A, dtype: torch.dtype, device, ws_cap: int = 512, K_cap: int = 64,
                 max_overhead: float = 24.0, row_pad: int = 8) -> Optional[BSG]:
    """BSG operator of a (pre-permuted) host sparse matrix, or None."""
    got = bsg_arrays(A, np_dtype(dtype), ws_cap=ws_cap, K_cap=K_cap, max_overhead=max_overhead, row_pad=row_pad)
    return None if got is None else bsg_op(got, device)
