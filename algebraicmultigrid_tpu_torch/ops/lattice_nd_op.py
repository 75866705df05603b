"""LatND — gather-free device operator for N-D lattice-structured levels.

Port of the JAX package's ``ops/lattice_nd_op.py``, the N-axis
generalisation of :class:`~.lattice_op.Lat2D`:

    y[i_0,…] = Σ_k data_k[i_0,…] · X[(i_0·p_0)//q_0 + d_0^k, …]

Each offset k is one (possibly strided or repeated) N-D slice of the
zero-padded input grid — multiply-add on whole grids, no gathers.  Covers
square level operators (all bases (1,1)) and the per-axis k-coarsened
transfer operators P/R of box aggregation.  Coefficients are stored in the
working dtype, or in bf16 under float32 vectors (``coef_dtype``, the JAX
package's ``AMG_COEF_DTYPE=bfloat16``): the planes expanded at float32 and
rounded, multiplied as float32 values in float32 arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .lattice_op import _axis_take, grid_first, grid_last
from .sparse import round_up

__all__ = ["LatND", "latnd_from_spec", "latnd_spmv"]


@dataclasses.dataclass(frozen=True)
class LatND:
    data: torch.Tensor  # [n_off, *row_dims]
    offsets: Tuple[Tuple[int, ...], ...]
    row_dims: Tuple[int, ...]
    col_dims: Tuple[int, ...]
    bases: Tuple[Tuple[int, int], ...]
    shape: Tuple[int, int]
    nnz: int
    rows_padded: int
    # the vectors' dtype where it is not the planes' (bf16 planes); None:
    # the planes' own
    vec_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self):
        """The working dtype of the level's vectors."""
        return self.vec_dtype or self.data.dtype


def expand_planes_nd(spec, dtype, device) -> torch.Tensor:
    """[n_off, *row_dims] planes from the class table: plane[k, i_0, …] =
    table[k, c_0[i_0], …].  The (tiny) table is cast to the target dtype
    first, as the JAX package's expansion does, then indexed on the device:
    the selection copies table entries exactly."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    T = torch.as_tensor(np.asarray(spec.table, dtype=np_dtype), device=device)
    N = spec.ndim
    idx = []
    for a, cls in enumerate(spec.row_class_arrays()):
        shape = [1] * N
        shape[a] = -1
        idx.append(torch.as_tensor(cls, dtype=torch.long, device=device).view(shape))
    return T[(slice(None), *idx)].contiguous()


def latnd_from_spec(spec, dtype, device, row_pad: int = 8, coef_dtype=None) -> LatND:
    """Instantiate a device LatND from a host LatticeSpecND.  With
    ``coef_dtype=torch.bfloat16`` the planes are expanded at float32 and
    rounded to bf16 under vectors of ``dtype``; the caller asks for it under
    float32 only, as the JAX package does."""
    n_r = int(np.prod(spec.row_dims))
    data = expand_planes_nd(spec, dtype if coef_dtype is None else torch.float32, device)
    return LatND(
        data=data if coef_dtype is None else data.to(coef_dtype),
        offsets=tuple(tuple(int(v) for v in d) for d in spec.offsets),
        row_dims=tuple(int(w) for w in spec.row_dims),
        col_dims=tuple(int(w) for w in spec.col_dims),
        bases=tuple(tuple(int(v) for v in b) for b in spec.bases),
        shape=(n_r, int(np.prod(spec.col_dims))),
        nnz=spec.nnz(),
        rows_padded=max(round_up(n_r, row_pad), row_pad),
        vec_dtype=None if coef_dtype is None else dtype,
    )


def latnd_spmv(A: LatND, x: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """y = A·x for a flat (padded) x, or a multi-RHS block ``x[n, k]``;
    returns y of length rows_padded (by k).  bf16 planes multiply as
    float32 values in float32 arithmetic (the JAX package's
    ``result_type(bf16, f32)``).  ``row0`` makes ``A`` the block of the
    leading grid axis from ``row0`` on, as in ``lat2d_spmv``."""
    N = len(A.row_dims)
    X = grid_first(x, int(np.prod(A.col_dims)), A.col_dims)  # [(k,) *col_dims]
    lead = X.dim() - N
    margins = [max((abs(d[a]) for d in A.offsets), default=0) for a in range(N)]
    pads = []
    for m in reversed(margins):  # F.pad takes the last axis first
        pads += [m, m]
    Xp = torch.nn.functional.pad(X, pads)

    y = torch.zeros(X.shape[:lead] + tuple(A.row_dims), dtype=torch.promote_types(A.data.dtype, x.dtype),
                    device=x.device)
    for k, d in enumerate(A.offsets):
        g = Xp
        for a in range(N):
            g = _axis_take(g, lead + a, d[a], margins[a], A.row_dims[a], A.bases[a], row0 if a == 0 else 0)
        y = y + A.data[k] * g
    return grid_last(y, int(np.prod(A.row_dims)), A.rows_padded, x.dim() == 2)
