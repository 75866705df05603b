"""Explicit halo-exchange SpMV for slab-sharded lattice operators.

Port of the JAX package's ``parallel/halo.py``.  A rank holds one x-slab of
the grid: rows [r·loc, (r + 1)·loc) of the level's [Wx, Wy] planes, loc =
Wx / n_sh.  The SpMV of a square Lat2D operator needs only the ``reach``
edge rows of the two slab neighbours (O(surface) traffic):

1. ``exchange_rows`` sends this rank's top rows to the rank above and its
   bottom rows to the rank below, and receives theirs, with
   ``torch.distributed`` point-to-point calls (``batch_isend_irecv``); the
   chain ends read zeros (the JAX ``ppermute`` pair);
2. the stencil runs on the halo-padded slab.

``lat2d_spmv_halo(..., overlap=True)`` runs K8 instead
(``async_halo.py``): the same function with the exchange overlapping the
interior rows' stencil.  The keyword replaces the JAX package's
``AMG_ASYNC_HALO=1`` switch.

The functions are SPMD: each rank calls them with its own slab of x (not
the global vector the JAX ``shard_map`` takes) and gets its slab of y.
gloo's point-to-point calls take host tensors, so a rank on a card under
gloo stages its edge rows through host memory (``RowMesh.staged``).
"""

from __future__ import annotations

import torch

from ..ops.kernels.halo_stencil import stencil_reach
from ..ops.lattice_op import Lat2D
from .dist import RowMesh

__all__ = ["lat2d_spmv_halo", "shard_slab", "exchange_rows"]

# message tags: rows travelling down the chain (rank r → r + 1) and up it
_DOWN, _UP = 0, 1


def shard_slab(x, mesh: RowMesh, Wx: int, Wy: int) -> torch.Tensor:
    """This rank's x-slab of a flat (Wx·Wy) grid vector, on its device."""
    if Wx % mesh.n_sh:
        raise ValueError(f"{mesh.n_sh} x-slabs do not divide {Wx} rows")
    loc = Wx // mesh.n_sh
    x = torch.as_tensor(x)
    return x[mesh.rank * loc * Wy : (mesh.rank + 1) * loc * Wy].to(mesh.device).contiguous()


def post_exchange(mesh: RowMesh, sends, recvs) -> list:
    """Post this rank's edge-row messages: ``sends`` = (rows for the rank
    above, rows for the rank below), ``recvs`` = (buffer for the rank
    above's rows, buffer for the rank below's); a chain end posts nothing
    on its open side.  Returns the works to wait on."""
    import torch.distributed as dist

    ops = []
    r = mesh.rank
    if r > 0:
        ops.append(dist.P2POp(dist.isend, sends[0], r - 1, tag=_UP))
        ops.append(dist.P2POp(dist.irecv, recvs[0], r - 1, tag=_DOWN))
    if r < mesh.n_sh - 1:
        ops.append(dist.P2POp(dist.isend, sends[1], r + 1, tag=_DOWN))
        ops.append(dist.P2POp(dist.irecv, recvs[1], r + 1, tag=_UP))
    return dist.batch_isend_irecv(ops) if ops else []


def wait_all(works, mesh: RowMesh):
    """Wait for point-to-point works: gloo's block the host (failing after
    the mesh's timeout); NCCL's make the current stream wait."""
    for w in works:
        if mesh.backend == "gloo":
            w.wait(mesh.timeout)
        else:
            w.wait()


def exchange_rows(top: torch.Tensor, bot: torch.Tensor, mesh: RowMesh):
    """(from_above, from_below): the rank above's ``bot`` rows and the rank
    below's ``top`` rows, zeros at the chain ends (open boundary)."""
    from_above = torch.zeros_like(bot)
    from_below = torch.zeros_like(top)
    if mesh.n_sh == 1 or top.numel() == 0:
        return from_above, from_below
    if mesh.staged:
        sends = (top.cpu(), bot.cpu())
        recvs = (torch.zeros_like(sends[1]), torch.zeros_like(sends[0]))
        wait_all(post_exchange(mesh, sends, recvs), mesh)
        return recvs[0].to(top.device), recvs[1].to(top.device)
    wait_all(post_exchange(mesh, (top.contiguous(), bot.contiguous()), (from_above, from_below)), mesh)
    return from_above, from_below


def slab_operator(A: Lat2D, mesh: RowMesh):
    """(planes of this rank's slab [n_off, loc, Wy], loc, Wy, reach, my) of
    a square Lat2D whose ``data`` holds either the whole grid's planes or
    already this rank's slab of them; a slab of whole planes is a view."""
    Wx, Wy = A.row_dims
    if A.base_x != (1, 1) or A.base_y != (1, 1):
        raise ValueError("square stencils only")
    if Wx % mesh.n_sh:
        raise ValueError(f"{mesh.n_sh} x-slabs do not divide {Wx} rows")
    loc = Wx // mesh.n_sh
    rows = A.data.shape[1]
    if rows == loc:
        data = A.data
    elif rows == Wx:
        data = A.data[:, mesh.rank * loc : (mesh.rank + 1) * loc]
    else:
        raise ValueError(f"planes of {rows} rows are neither the grid's {Wx} nor a slab's {loc}")
    return (data, loc, Wy) + stencil_reach(A.offsets)


def slab_of(x: torch.Tensor, loc: int, Wy: int) -> torch.Tensor:
    if x.dim() != 1 or x.shape[0] < loc * Wy:
        raise ValueError(f"x must be this rank's flat slab of {loc}x{Wy} entries, got {tuple(x.shape)}")
    return x[: loc * Wy].reshape(loc, Wy)


def lat2d_spmv_halo(A: Lat2D, x: torch.Tensor, mesh: RowMesh, overlap: bool = False) -> torch.Tensor:
    """y = A·x on this rank's slab, with the neighbours' edge rows
    exchanged.  ``A`` is square (base (1, 1)); ``x`` is this rank's flat
    slab of loc·Wy entries (Wx divisible by the mesh's n_sh); returns this
    rank's flat slab of y.  ``overlap=True`` runs K8, which overlaps the
    exchange with the interior rows (``async_halo.lat2d_spmv_halo_async``)."""
    if overlap:
        from .async_halo import lat2d_spmv_halo_async

        return lat2d_spmv_halo_async(A, x, mesh)
    data, loc, Wy, reach, my = slab_operator(A, mesh)
    X = slab_of(x, loc, Wy)
    from_above, from_below = exchange_rows(X[:reach], X[loc - reach :], mesh)
    Xp = torch.nn.functional.pad(torch.cat([from_above, X, from_below], dim=0), (my, my))
    y = torch.zeros((loc, Wy), dtype=torch.promote_types(data.dtype, X.dtype), device=X.device)
    for k, (dx, dy) in enumerate(A.offsets):
        y = y + data[k] * Xp[reach + dx : reach + dx + loc, my + dy : my + dy + Wy]
    return y.reshape(loc * Wy)
