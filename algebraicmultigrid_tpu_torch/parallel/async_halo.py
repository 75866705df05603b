"""K8's driver: the slab SpMV with the halo exchange overlapping the stencil.

Port of the JAX package's ``parallel/async_halo.py``
(``lat2d_spmv_halo_async``), same contract as ``halo.lat2d_spmv_halo``.
The TPU kernel signals a barrier, starts remote copies of its edge rows to
both slab neighbours, computes the interior rows while they fly, waits for
the receives and computes the boundary rows, all inside one kernel.  A
Hopper kernel does not copy to another card; NCCL does, outside the kernel.
So on a card, per call:

1. the communication stream (``RowMesh.comm_stream``) waits for x, and
   the edge-row sends and the halo receives are posted on it;
2. the interior-rows kernel (K8 part ``"interior"``, rows reach … loc −
   reach, local x only) is launched on the compute stream, where it
   overlaps the exchange;
3. the compute stream waits for the exchange;
4. the boundary-rows kernel (part ``"boundary"``) reads the received halo,
   zeros at the chain ends.

So each call launches K8 twice (once when the slab has no interior rows,
loc = 2·reach).  Under NCCL step 3 is a stream wait and the host does not
block.  Under gloo on a card (several ranks sharing it) the edge rows go
through pinned host memory: the host waits for their copy, runs gloo's
exchange while the interior kernel runs, and copies the halo back on the
compute stream.  On the CPU (gloo) the same steps run the kernels' plain
versions.  Where there is no neighbour (one slab) the halo is zero and
nothing is exchanged.
"""

from __future__ import annotations

import torch

from ..ops.kernels.halo_stencil import halo_stencil
from ..ops.lattice_op import Lat2D
from .dist import RowMesh
from .halo import post_exchange, slab_of, slab_operator, wait_all

__all__ = ["lat2d_spmv_halo_async"]


def lat2d_spmv_halo_async(A: Lat2D, x: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """y = A·x on this rank's slab with the exchange overlapped (same
    contract as :func:`~.halo.lat2d_spmv_halo`)."""
    data, loc, Wy, reach, _ = slab_operator(A, mesh)
    if loc < 2 * reach:
        raise ValueError(f"a slab of {loc} rows is thinner than twice the stencil's reach {reach}")
    X = slab_of(x, loc, Wy).contiguous()
    if data.dtype != X.dtype:
        raise TypeError(f"x has dtype {X.dtype}, the operator {data.dtype}")
    offsets = A.offsets
    y = torch.empty_like(X)
    if mesh.n_sh == 1 or reach == 0:
        halo_stencil(data, X, None, offsets, "interior", y)
        halo_stencil(data, X, None, offsets, "boundary", y)
        return y.reshape(loc * Wy)
    halo = X.new_zeros((2, reach, Wy))
    top, bot = X[:reach], X[loc - reach :]
    if X.device.type != "cuda":
        works = post_exchange(mesh, (top, bot), (halo[0], halo[1]))
        halo_stencil(data, X, None, offsets, "interior", y)
        wait_all(works, mesh)
    elif mesh.staged:
        comm = mesh.comm_stream
        comm.wait_stream(torch.cuda.current_stream(X.device))
        sent = torch.empty((2, reach, Wy), dtype=X.dtype, pin_memory=True)
        got = torch.zeros((2, reach, Wy), dtype=X.dtype, pin_memory=True)
        with torch.cuda.stream(comm):
            sent[0].copy_(top, non_blocking=True)
            sent[1].copy_(bot, non_blocking=True)
        halo_stencil(data, X, None, offsets, "interior", y)
        comm.synchronize()  # the edge rows are in host memory; the interior runs on
        wait_all(post_exchange(mesh, (sent[0], sent[1]), (got[0], got[1])), mesh)
        halo.copy_(got, non_blocking=True)
    else:
        comm = mesh.comm_stream
        comm.wait_stream(torch.cuda.current_stream(X.device))
        with torch.cuda.stream(comm):
            works = post_exchange(mesh, (top, bot), (halo[0], halo[1]))
        halo_stencil(data, X, None, offsets, "interior", y)
        wait_all(works, mesh)  # NCCL: the compute stream waits, the host does not
    halo_stencil(data, X, halo, offsets, "boundary", y)
    return y.reshape(loc * Wy)
