"""Natural-order Gauss-Seidel / SOR sweeps on a small ELL level.

Not the port of a Pallas kernel: the JAX package runs these sweeps as an
XLA ``lax.scan`` row recurrence (``models/device.py::_scan_sweep``), which
levels of at most 2048 rows use for natural-order GS/SOR.  Per row i, in
row order (forward) or reverse order (backward):

    rsum = Σ_w data[i,w]·x[cols[i,w]] − d_i·x_i
    x_i  ← x_i                                   if d_i == 0 (frozen)
           (1 − ω)·x_i + ω·(b_i − rsum) / d_i     otherwise

``smooth_scan_gs`` runs one smoother application (``iter`` times a forward
and/or backward sweep) as one launch of the CUDA kernel
(``csrc/scan_gs.cu``) on a CUDA tensor, and ``smooth_scan_gs_reference``,
a plain PyTorch row loop, on a CPU tensor.
"""

from __future__ import annotations

import torch

from ..sparse import ELL
from .vcycle_legs import SUFFIX, _stream, check_vector, launches, load_library, raise_on

__all__ = ["smooth_scan_gs", "smooth_scan_gs_reference"]


def _sweep(A: ELL, diag, x, b, omega: float, rows):
    data = A.data if x.dim() == 1 else A.data.unsqueeze(-1)
    for i in rows:
        d = diag[i]
        xi = x[i]
        rsum = (data[i] * x[A.cols[i]]).sum(dim=0) - d * xi
        cand = (1 - omega) * xi + omega * (b[i] - rsum) / torch.where(d == 0, torch.ones_like(d), d)
        x[i] = torch.where(d == 0, xi, cand)


def smooth_scan_gs_reference(A: ELL, diag, x, b, omega: float, iters: int, forward: bool, backward: bool):
    """The smoother in plain PyTorch: a row loop; returns a new x.  x and b
    may be multi-RHS blocks [n, k]."""
    x = x.clone()
    n = A.shape[0]  # the padding rows have d = 0 and stay frozen
    for _ in range(iters):
        if forward:
            _sweep(A, diag, x, b, omega, range(n))
        if backward:
            _sweep(A, diag, x, b, omega, range(n - 1, -1, -1))
    return x


def smooth_scan_gs(A: ELL, diag, x, b, omega: float, iters: int, forward: bool, backward: bool):
    """``iters`` forward and/or backward natural-order sweeps of x on A·x = b
    (x, b and diag flat at ``A.rows_padded``); returns a new x.  Multi-RHS
    blocks x, b [n, k] run the kernel column by column on the card."""
    if x.device.type == "cpu":
        return smooth_scan_gs_reference(A, diag, x, b, omega, iters, forward, backward)
    if x.device.type != "cuda":
        raise ValueError(f"smooth_scan_gs runs on cuda or cpu tensors, not {x.device}")
    if x.dim() == 2:
        cols = [
            smooth_scan_gs(A, diag, x[:, j].contiguous(), b[:, j].contiguous(), omega, iters, forward, backward)
            for j in range(x.shape[1])
        ]
        return torch.stack(cols, dim=1)
    rows = A.rows_padded
    for name, t in (("x", x), ("b", b), ("diag", diag)):
        check_vector(name, t, A.data, rows)
    if A.dtype not in SUFFIX:
        raise TypeError(f"smooth_scan_gs takes float32 or float64, not {A.dtype}")
    if A.shape[1] > rows or A.cols.dtype != torch.int64 or not (A.data.is_contiguous() and A.cols.is_contiguous()):
        raise ValueError("smooth_scan_gs takes a square contiguous ELL level with int64 columns")
    x_out = torch.empty_like(x)
    if x.shape[0] > rows:
        x_out[rows:] = x[rows:]
    fn = getattr(load_library(), f"amg_scan_gs_{SUFFIX[x.dtype]}")
    err = fn(
        x_out.data_ptr(), x.data_ptr(), b.data_ptr(), A.data.data_ptr(), A.cols.data_ptr(),
        diag.data_ptr(), rows, A.width, float(omega), int(iters), int(forward), int(backward),
        _stream(x),
    )
    raise_on(err, "scan_gs kernel")
    launches["scan_gs"] += 1
    return x_out
