"""The row "mesh" of the multi-GPU tier, on ``torch.distributed``, and the
generic sharded hierarchy.

Port of the JAX package's ``parallel/dist.py``.  JAX
runs one controller over a ``Mesh`` of devices and ``shard_map`` hands each
device its slab; here every slab is one process of a ``torch.distributed``
process group (SPMD): the rank holds its slab on its own device, every rank
runs the same program, and the collectives of ``halo.py`` and
``lattice_cycle.py`` stand in for ``ppermute`` / ``all_gather`` / ``psum``.

The backend is the caller's choice:

* ``"nccl"``: one card per rank (rank r on ``cuda:LOCAL_RANK``), as
  ``torchrun --nproc-per-node=N`` starts them; it raises when the host has
  fewer cards than ranks;
* ``"gloo"``: ranks on the CPU (``device="cpu"``) or several ranks sharing
  one card (``device="cuda"``); gloo's point-to-point calls take host
  tensors, so ``halo.py`` stages the edge rows of a card through host
  memory.

One process with no ``init_method`` and ``world_size`` 1 gets a mesh of one
slab and no process group: the n_sh = 1 program, with no collective.

``run_ranks`` starts n_sh ranks on this host (``spawn``: CUDA cannot fork),
runs a function on each and returns their results; a rank that fails or
does not answer within its time limit fails the call.

``shard_hierarchy`` / ``build_sharded_hierarchy`` / ``solve_sharded`` are
the generic tier: any device hierarchy, its big levels' operators and
smoother arrays held as each rank's row block (``rows.py``) and every level
vector whole on every rank.  The JAX package annotates shardings and lets
XLA insert the collectives; here a sharded SpMV or smoother step computes
the rank's rows and all-gathers them, and the single-device cycle and
solve loop (``models/device.py``) run unchanged: each row is computed as
on one device, and every rank holds the same vectors, so the norms, the
iteration count and x are the same on every rank.  What stays whole, as
in the JAX module: the small levels (fewer than ``replicate_below`` rows),
R, BSG and BT operators (K6 runs on every rank), a lattice whose leading
axis does not split evenly, the gathered multicolor cache, the coarse
solve, ``final_A`` and the RCM basis.  The single-card caches go: the
fused legs, the tail and the subcycle, and K5's cache for its masked
fallback; K7's cache goes for its masked fallback on a sharded level.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import socket
import time
import traceback
from typing import Optional

import torch

from ..config import V

__all__ = [
    "RowMesh", "make_row_mesh", "run_ranks", "DEFAULT_TIMEOUT_S", "shard_hierarchy", "build_sharded_hierarchy",
    "solve_sharded",
]

# every collective and point-to-point call of the tier fails after this long
DEFAULT_TIMEOUT_S = 300.0
BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """One rank's view of the 1-D slab axis."""

    rank: int
    n_sh: int
    device: torch.device
    backend: str  # "nccl" | "gloo", or "none" for one slab in one process
    timeout: datetime.timedelta
    # the stream K8's halo exchange runs on, beside the compute stream (a
    # card's mesh only)
    comm_stream: Optional[torch.cuda.Stream] = None

    @property
    def staged(self) -> bool:
        """Whether messages of this rank's device go through host memory
        (gloo on a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def _device(device, backend: str, rank: Optional[int] = None):
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK", os.environ.get("RANK", rank or 0))
        return torch.device("cuda", int(local))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA card is available: the slab tier runs on the card; pass device='cpu' to run it on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _mesh(rank, n_sh, device, backend, timeout) -> RowMesh:
    comm = torch.cuda.Stream(device) if device.type == "cuda" else None
    return RowMesh(rank=rank, n_sh=n_sh, device=device, backend=backend, timeout=timeout, comm_stream=comm)


def make_row_mesh(
    backend: str = "gloo",
    *,
    device=None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> RowMesh:
    """This process's rank on the slab axis.

    Joins the default process group, initialising it with ``backend``,
    ``init_method`` (``"tcp://localhost:<port>"``, or ``"env://"`` under
    ``torchrun``), ``world_size`` and ``rank`` unless it already exists.
    Without ``init_method`` and with ``world_size`` None or 1 it returns
    the one-slab mesh of this process and starts no group.  ``device`` is
    the rank's device under gloo (default: the card; ``"cpu"`` runs the
    plain versions); under nccl each rank takes the card ``LOCAL_RANK``.
    """
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend is one of {BACKENDS}, not {backend!r}")
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized() and init_method is None and world_size in (None, 1):
        return _mesh(0, 1, _device(device, "gloo"), "none", timeout)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA card per rank, and there is none")
        ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", world_size or os.environ.get("WORLD_SIZE", "1")))
        if torch.cuda.device_count() < ranks_here:
            raise RuntimeError(
                f"the nccl backend needs one card per rank: {ranks_here} ranks on this host, "
                f"{torch.cuda.device_count()} cards; run several ranks on one card with backend='gloo'"
            )
    dev = _device(device, backend, rank)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank, timeout=timeout,
        )
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    return _mesh(dist.get_rank(), dist.get_world_size(), dev, backend, timeout)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n_sh, port, backend, device, timeout_s, results, args):
    """One spawned rank: join the group, run ``fn(mesh, *args)``, send
    (rank, ok, result or traceback) back."""
    import torch.distributed as dist

    # ranks of one host talk over loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if backend == "nccl":
        os.environ["LOCAL_RANK"] = str(rank)
        os.environ["LOCAL_WORLD_SIZE"] = str(n_sh)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_sh))
    try:
        mesh = make_row_mesh(
            backend, device=device, init_method=f"tcp://127.0.0.1:{port}", world_size=n_sh, rank=rank,
            timeout_s=min(timeout_s, DEFAULT_TIMEOUT_S),
        )
        results.put((rank, True, fn(mesh, *args)))
    except Exception:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, n_sh: int, *args, backend: str = "gloo", device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on ``n_sh`` ranks of this host and return
    their results in rank order.  ``fn`` and ``args`` must pickle (a
    module-level function); each rank is a fresh ``spawn``ed process.
    Raises RuntimeError with every failed rank's traceback, or when the
    ranks have not all answered within ``timeout_s``; every rank is joined,
    and killed if it outlives the call.  The ranks' collectives time out
    after ``min(timeout_s, DEFAULT_TIMEOUT_S)``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(target=_rank_main, args=(fn, r, n_sh, port, backend, device, timeout_s, results, args), daemon=True)
        for r in range(n_sh)
    ]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < n_sh:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(n_sh)) - set(got))
                raise RuntimeError(f"ranks {missing} did not answer within {timeout_s} s")
            try:
                r, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} died without an answer (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})") from None
                continue
            got[r] = (ok, val)
            if not ok:
                # the others may wait on the failed rank: give them a moment
                deadline = min(deadline, time.monotonic() + 10.0)
    except RuntimeError as e:
        failed = {r: v for r, (ok, v) in got.items() if not ok}
        if failed:
            raise RuntimeError(_failures(failed)) from e
        raise
    finally:
        for p in procs:
            p.join(timeout=10.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
    failed = {r: v for r, (ok, v) in got.items() if not ok}
    if failed:
        raise RuntimeError(_failures(failed))
    return [got[r][1] for r in range(n_sh)]


def _failures(failed: dict) -> str:
    return "\n".join(f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items()))


# --------------------------------------------------------------------------
# the generic sharded hierarchy (the JAX module's shard_hierarchy,
# build_sharded_hierarchy and solve_sharded)
# --------------------------------------------------------------------------


def _single_card_off(cache, sharded: bool):
    """K5's cache → its masked fallback (as the JAX module drops
    ``PallasGSCache``); K7's on a sharded level, whose rank holds no whole
    operator to sweep."""
    from ..ops.kernels.gs_sweep import GSSweepCache
    from ..ops.kernels.sweep3d import Sweep3DCache

    if isinstance(cache, GSSweepCache) or (sharded and isinstance(cache, Sweep3DCache)):
        if cache.fallback is None:
            raise ValueError(f"this {type(cache).__name__} has no masked fallback to shard")
        return cache.fallback
    return cache


def shard_hierarchy(h, mesh: RowMesh, *, replicate_below: int = 4096):
    """This rank's view of a device hierarchy (built on ``mesh.device``):
    levels of at least ``replicate_below`` rows whose padded rows split
    evenly over the ranks hold their A, P and smoother arrays as this
    rank's row block; everything else stays whole; the fused legs, the
    tail and the subcycle are dropped.  At one rank nothing is blocked."""
    from ..models.device import DeviceHierarchy, DeviceLevel
    from .rows import shard_op, shard_smoother

    n_sh = mesh.n_sh
    levels = []
    for level in h.levels:
        big = n_sh > 1 and level.A.shape[0] >= replicate_below and level.A.rows_padded % n_sh == 0
        pre, post = (_single_card_off(c, big) for c in (level.pre, level.post))
        levels.append(DeviceLevel(
            A=shard_op(level.A, mesh) if big else level.A,
            P=shard_op(level.P, mesh) if big else level.P,
            R=level.R,
            pre=shard_smoother(pre, mesh) if big else pre,
            post=shard_smoother(post, mesh) if big else post,
            fused=None,
        ))
    return DeviceHierarchy(levels=tuple(levels), coarse=h.coarse, final_A=h.final_A, perm0=h.perm0, iperm0=h.iperm0)


def _dtype_name(dtype) -> str:
    return "auto" if dtype is None else str(dtype).removeprefix("torch.")


def build_sharded_hierarchy(ml, mesh: RowMesh, dtype=None, replicate_below: int = 4096):
    """The device hierarchy padded to ``8·n_sh`` rows a level and sharded
    over ``mesh`` (this rank's view), built on first use and cached on
    ``ml`` under the JAX module's key."""
    from ..models.device import _resolve, build_device_hierarchy

    key = ("sharded", _dtype_name(dtype), mesh.n_sh, replicate_below)
    if key not in ml._device_cache:
        device, dt = _resolve(ml, mesh.device, dtype)
        h = build_device_hierarchy(ml, device=device, dtype=dt, fused=False, tail=False, row_pad=8 * mesh.n_sh)
        ml._device_cache[key] = shard_hierarchy(h, mesh, replicate_below=replicate_below)
    return ml._device_cache[key]


def solve_sharded(
    ml,
    b,
    cycle=V(),
    *,
    mesh: Optional[RowMesh] = None,
    maxiter: int = 100,
    abstol: float = 0.0,
    reltol: Optional[float] = None,
    calculate_residual: bool = True,
    dtype=None,
    replicate_below: int = 4096,
):
    """The stationary multigrid solve over the sharded hierarchy: every rank
    calls it with the same ``b`` (flat, or a multi-RHS block ``[n, k]``)
    and gets the same ``(x, iterations, ‖r‖)``, x in the caller's order.
    ``mesh`` defaults to ``make_row_mesh()`` (one rank, on the card);
    ``reltol`` to √eps of the working dtype, and the stopping test is
    ‖r‖ ≤ max(reltol·‖b‖, abstol)."""
    import math

    import numpy as np

    from ..models.device import _solve_fused, fit_len

    if mesh is None:
        mesh = make_row_mesh()
    h = build_sharded_hierarchy(ml, mesh, dtype=dtype, replicate_below=replicate_below)
    wdtype = h.levels[0].A.dtype if h.levels else h.final_A.dtype
    b_arr = torch.as_tensor(np.asarray(b), device=mesh.device).to(wdtype)
    n = b_arr.shape[0]
    bp = fit_len(b_arr, h.fine_padded)
    if reltol is None:
        reltol = math.sqrt(torch.finfo(wdtype).eps)
    normb = float(torch.linalg.norm(b_arr))
    if normb != 0:
        abstol = max(reltol * normb, abstol)
    xq, iters, normres = _solve_fused(h, bp, maxiter, abstol, cycle, calculate_residual)
    return xq[:n].cpu().numpy(), int(iters), float(normres)
