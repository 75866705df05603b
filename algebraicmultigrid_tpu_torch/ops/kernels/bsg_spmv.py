"""K6: the BSG SpMV, y = A·x over the windowed-ELL layout of ``ops/bsg.py``.

Port of the JAX package's ``ops/bsg.py::_bsg_kernel`` (via ``bsg_spmv``):

    y[t·1024 + u·128 + j] = Σ_k data[t,k,u,j] · x[m0[t]·128 + off[t,k,u,j]]

accumulated in float32 in slot order.  ``bsg_spmv`` launches the CUDA
kernel (``csrc/bsg_spmv.cu``, a thread per row gathering x directly) on a
CUDA tensor and runs ``bsg_spmv_reference``, a plain PyTorch gather and
slot-ordered sum, on a CPU tensor.  As in the JAX package, x is read as
``x[:cols_padded]`` followed by ``ws`` zero guard blocks.
"""

from __future__ import annotations

import torch

from ..bsg import BSG, LANES, TILE_ROWS
from .vcycle_legs import _stream, launches, load_library, raise_on

__all__ = ["bsg_spmv", "bsg_spmv_reference"]


def _check(B: BSG, x: torch.Tensor):
    if x.dim() != 1:
        raise ValueError(f"bsg_spmv takes a flat vector, got shape {tuple(x.shape)}")
    if x.dtype != B.data.dtype:
        raise TypeError(f"x has dtype {x.dtype}, the operator {B.data.dtype}")
    if x.shape[0] < B.shape[1]:
        raise ValueError(f"x has {x.shape[0]} entries, the operator {B.shape[1]} columns")


def bsg_spmv_reference(B: BSG, x: torch.Tensor) -> torch.Tensor:
    """y = B·x in plain PyTorch; y has ``B.rows_padded`` entries."""
    _check(B, x)
    nc = B.cols_padded
    xp = torch.zeros(nc + B.ws * LANES, dtype=x.dtype, device=x.device)
    m = min(nc, x.shape[0])
    xp[:m] = x[:m]
    T, K = B.n_tiles, B.width
    idx = B.m0.long().view(T, 1, 1, 1) * LANES + B.off.long()  # [T, K, 8, 128]
    g = xp[idx]
    acc = torch.zeros((T, 8, LANES), dtype=x.dtype, device=x.device)
    for k in range(K):
        acc = acc + B.data[:, k] * g[:, k]
    return acc.reshape(T * TILE_ROWS)[: B.rows_padded]


def bsg_spmv(B: BSG, x: torch.Tensor) -> torch.Tensor:
    """y = B·x for a flat float32 x of at least ``B.shape[1]`` entries;
    returns y of ``B.rows_padded`` entries (zero beyond ``B.shape[0]``).
    A multi-RHS block ``x[n, k]`` runs column by column (k launches on the
    card), as the JAX package's ``bsg_spmv`` does."""
    if x.dim() == 2:
        return torch.stack([bsg_spmv(B, x[:, j].contiguous()) for j in range(x.shape[1])], dim=1)
    if x.device.type == "cpu":
        return bsg_spmv_reference(B, x)
    if x.device.type != "cuda":
        raise ValueError(f"bsg_spmv runs on cuda or cpu tensors, not {x.device}")
    _check(B, x)
    if B.data.device != x.device:
        raise ValueError(f"x is on {x.device}, the operator on {B.data.device}")
    if B.data.dtype != torch.float32:
        raise TypeError(f"the BSG kernel takes float32, not {B.data.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    y = torch.empty(B.rows_padded, dtype=x.dtype, device=x.device)
    err = load_library().amg_bsg_spmv_f32(
        y.data_ptr(), B.data.data_ptr(), B.off.data_ptr(), B.m0.data_ptr(), x.data_ptr(),
        min(x.shape[0], B.cols_padded), B.n_tiles, B.width, B.rows_padded, _stream(x),
    )
    raise_on(err, "bsg_spmv kernel")
    launches["bsg"] += 1
    return y
