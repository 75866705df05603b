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

The kernel shortens the recurrence's chain (``csrc/scan_gs.cu`` has the
design): at the start of a sweep every row's not-yet-updated part (the
slots right of the diagonal in a forward sweep, left of it in a backward
one, and the diagonal) is summed for all rows at once, and only the other
half stays on the row-by-row chain.  ``split_scan_gs`` lays the level out
for it when the cache is built: each row's left and right slots,
column-major ``[w, rows]`` with int16 columns (a level has at most 2048
rows), ``dshift = a_ii − d``, and the route: ``"staged"`` (the halves in
shared memory for the launch) where they fit, else ``"streamed"`` (the
halves read from device memory, the next row's slots fetched while a row
reduces).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sparse import ELL
from .vcycle_legs import SMEM_LIMIT, SUFFIX, _stream, check_vector, launches, load_library, raise_on

__all__ = [
    "ScanGSCache", "ScanGSSplit", "plan_scan_route", "scan_gs_cache", "smooth_scan_gs", "smooth_scan_gs_reference",
    "split_scan_gs",
]

MAX_ROWS = 32_767   # int16 columns


@dataclasses.dataclass(frozen=True)
class ScanGSSplit:
    """A level laid out for the kernel: the slots left (``lo_*``, cols < i)
    and right (``up_*``, cols > i) of each row's diagonal, ``[w, rows]``,
    zero data in a row's unused slots; ``dshift`` = a_ii − d."""

    lo_data: torch.Tensor
    lo_cols: torch.Tensor  # int16
    up_data: torch.Tensor
    up_cols: torch.Tensor  # int16
    dshift: torch.Tensor   # [rows]
    route: str             # "staged" or "streamed"

    @property
    def rows(self) -> int:
        return self.dshift.shape[0]


@dataclasses.dataclass(frozen=True)
class ScanGSCache:
    """The exact natural-order GS/SOR recurrence over ELL rows."""

    diag: torch.Tensor  # [rows_padded]
    omega: float
    iter: int
    forward: bool
    backward: bool
    # the level laid out for the CUDA kernel; None: the cache runs only its
    # plain version (CPU tensors)
    split: ScanGSSplit = None


def smem_bytes(rows: int, w_lo: int, w_up: int, itemsize: int, staged: bool) -> int:
    """Shared memory of a launch (``csrc/scan_gs.cu`` scan_smem_bytes): six
    row vectors, plus both halves with int16 columns when staged."""
    return 6 * rows * itemsize + (w_lo + w_up) * rows * (itemsize + 2) * staged


def plan_scan_route(rows: int, w_lo: int, w_up: int, itemsize: int):
    """(route, why): ``"staged"`` where the halves fit an SM's shared memory
    beside the row vectors, else ``"streamed"`` (why says so); raises where
    not even the row vectors fit or the columns pass int16."""
    if rows > MAX_ROWS:
        raise ValueError(f"scan_gs takes at most {MAX_ROWS} rows (int16 columns), not {rows}")
    if smem_bytes(rows, w_lo, w_up, itemsize, False) > SMEM_LIMIT:
        raise ValueError(f"scan_gs's row vectors of {rows} rows do not fit {SMEM_LIMIT} bytes of shared memory")
    need = smem_bytes(rows, w_lo, w_up, itemsize, True)
    if need <= SMEM_LIMIT:
        return "staged", None
    return "streamed", f"the halves need {need} bytes of shared memory (limit {SMEM_LIMIT})"


def split_scan_gs(A: ELL, diag) -> ScanGSSplit:
    """The kernel's layout of ELL level ``A`` with diagonal ``diag``
    [rows_padded], on A's device."""
    data = A.data.cpu().numpy()
    cols = A.cols.cpu().numpy()
    rows, dt = A.rows_padded, data.dtype
    if data.shape[0] != rows:
        raise ValueError(f"an ELL of {data.shape[0]} stored rows for {rows} padded rows")
    i = np.arange(rows)[:, None]
    live = data != 0
    lo, up = live & (cols < i), live & (cols > i)
    adiag = np.where(live & (cols == i), data, 0).sum(axis=1)
    halves = []
    for mask in (lo, up):
        w = int(mask.sum(axis=1).max(initial=0))
        # each row's slots of this half, in ELL order, packed to the left
        order = np.argsort(~mask, axis=1, kind="stable")[:, :w]
        keep = np.take_along_axis(mask, order, axis=1)
        hd = np.where(keep, np.take_along_axis(data, order, axis=1), 0).astype(dt)
        hc = np.where(keep, np.take_along_axis(cols, order, axis=1), 0).astype(np.int16)
        halves.append((np.ascontiguousarray(hd.T), np.ascontiguousarray(hc.T)))
    (lo_d, lo_c), (up_d, up_c) = halves
    dshift = (adiag - diag.cpu().numpy().astype(np.float64)).astype(dt)
    route, _ = plan_scan_route(rows, lo_d.shape[0], up_d.shape[0], data.itemsize)
    dev = A.data.device
    return ScanGSSplit(
        lo_data=torch.as_tensor(lo_d, device=dev), lo_cols=torch.as_tensor(lo_c, device=dev),
        up_data=torch.as_tensor(up_d, device=dev), up_cols=torch.as_tensor(up_c, device=dev),
        dshift=torch.as_tensor(dshift, device=dev), route=route,
    )


def scan_gs_cache(A: ELL, diag, omega: float, iters: int, fwd: bool, bwd: bool) -> ScanGSCache:
    """The natural-order smoother of ELL level ``A`` with its split."""
    return ScanGSCache(diag=diag, omega=float(omega), iter=int(iters), forward=bool(fwd), backward=bool(bwd),
                       split=split_scan_gs(A, diag))


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


def smooth_scan_gs(A: ELL, cache: ScanGSCache, x, b):
    """``cache.iter`` forward and/or backward natural-order sweeps of x on
    A·x = b (x, b and the cache's diag flat at ``A.rows_padded``); returns a
    new x.  Multi-RHS blocks x, b [n, k] run the kernel column by column on
    the card."""
    c = cache
    if x.device.type == "cpu":
        return smooth_scan_gs_reference(A, c.diag, x, b, c.omega, c.iter, c.forward, c.backward)
    if x.device.type != "cuda":
        raise ValueError(f"smooth_scan_gs runs on cuda or cpu tensors, not {x.device}")
    if x.dim() == 2:
        return torch.stack([smooth_scan_gs(A, c, x[:, j].contiguous(), b[:, j].contiguous())
                            for j in range(x.shape[1])], dim=1)
    sp = c.split
    if sp is None:
        raise ValueError("smooth_scan_gs: the cache has no split of its level (build it with scan_gs_cache)")
    rows = A.rows_padded
    for name, t in (("x", x), ("b", b), ("diag", c.diag), ("dshift", sp.dshift)):
        check_vector(name, t, A.data, rows)
    if A.dtype not in SUFFIX:
        raise TypeError(f"smooth_scan_gs takes float32 or float64, not {A.dtype}")
    if sp.rows != rows or sp.lo_data.dtype != A.dtype or sp.lo_data.device != x.device:
        raise ValueError("smooth_scan_gs: the cache's split is not of this level")
    x_out = torch.empty_like(x)
    if x.shape[0] > rows:
        x_out[rows:] = x[rows:]
    fn = getattr(load_library(), f"amg_scan_gs_{SUFFIX[x.dtype]}")
    err = fn(
        x_out.data_ptr(), x.data_ptr(), b.data_ptr(), sp.lo_data.data_ptr(), sp.lo_cols.data_ptr(),
        sp.up_data.data_ptr(), sp.up_cols.data_ptr(), sp.dshift.data_ptr(), c.diag.data_ptr(),
        rows, sp.lo_data.shape[0], sp.up_data.shape[0], c.omega, int(c.iter), int(c.forward), int(c.backward),
        int(sp.route == "staged"), _stream(x),
    )
    raise_on(err, "scan_gs kernel")
    launches["scan_gs"] += 1
    return x_out
