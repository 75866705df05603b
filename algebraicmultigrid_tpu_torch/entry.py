"""Entry points of the port: a single-card V-cycle step and a
multi-GPU dry run (the counterparts of the JAX package's
``__graft_entry__.entry`` / ``dryrun_multichip``).

* :func:`entry` returns ``(step, args)``: one V-cycle plus the residual
  norm on the 64² Poisson Ruge–Stüben hierarchy with multicolor GS, on the
  card (``device="cpu"`` for the plain versions);
* :func:`dryrun_multichip` runs, on ``n_devices`` ranks, one
  ``solve_sharded`` step on the 32² RS problem (``replicate_below=256``:
  its fine levels held as row blocks, the coarse ones whole) and a short
  ``solve_lattice_sharded`` at 144² (the slab tier).  The ranks run NCCL,
  a card each, where the host has ``n_devices`` cards, else gloo ranks
  sharing the card (or, with ``device="cpu"``, on the CPU).  Called inside
  a process group of ``n_devices`` ranks (``torchrun``), it runs in that
  group instead of starting ranks.

    python -m algebraicmultigrid_tpu_torch.entry
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """(step, (h, x0, b)): ``step(h, x, b)`` runs one V-cycle from x and
    returns (x, ‖b − A·x‖) as device tensors."""
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, _resolve, fit_len
    from algebraicmultigrid_tpu_torch.ops.banded import mat_vec

    gs = amt.GaussSeidel(ordering="multicolor")
    A = amt.poisson((64, 64))
    n = A.shape[0]
    ml = amt.ruge_stuben(A, presmoother=gs, postsmoother=gs)
    device, dtype = _resolve(ml, device, torch.float32)
    h = amt.build_device_hierarchy(ml, device=device, dtype=dtype)
    b = torch.zeros(h.fine_padded, dtype=dtype, device=device)
    b[:n] = torch.as_tensor(A @ np.ones(n), dtype=dtype, device=device)

    def step(h, x, b):
        x = _one_iteration(h, amt.V(), x, b)
        res = b - fit_len(mat_vec(h.levels[0].A, x), b.shape[0])
        return x, torch.linalg.norm(res)

    return step, (h, torch.zeros_like(b), b)


def _dryrun_rank(mesh):
    """One rank of the dry run; returns its iterations and residuals."""
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.parallel import solve_lattice_sharded, solve_sharded

    gs = amt.GaussSeidel(ordering="multicolor")
    A = amt.poisson((32, 32))  # tiny shapes: the dry run checks the sharding
    n = A.shape[0]
    b = (A @ np.ones(n)).astype(np.float32)
    ml = amt.ruge_stuben(A, presmoother=gs, postsmoother=gs)
    x, iters, normres = solve_sharded(ml, b, amt.V(), mesh=mesh, maxiter=1, dtype="float32", replicate_below=256)
    if x.shape != (n,) or not np.isfinite(normres):
        raise AssertionError(f"solve_sharded step: x {x.shape}, ‖r‖ {normres}")

    LP = amt.poisson((144, 144), lattice=True)
    mls = amt.structured_smoothed_aggregation(
        LP, proxy=36, cut_rows=2000, min_proxy_dim=16, aggregate=amt.StructuredAggregation(box=3),
    )
    xs, its, rr = solve_lattice_sharded(mls, LP @ np.ones(LP.shape[0]), mesh=mesh, tol=1e-4, maxiter=8, log=True)
    if xs.shape != (LP.shape[0],) or not np.isfinite(rr):
        raise AssertionError(f"solve_lattice_sharded: x {xs.shape}, relres {rr}")
    return dict(rank=mesh.rank, n_sh=mesh.n_sh, backend=mesh.backend, iters=iters, normres=normres,
                lattice_iters=its, lattice_relres=rr)


def dryrun_multichip(n_devices: int, *, device=None, timeout_s: float = 600.0) -> list:
    """Run the dry run on ``n_devices`` ranks (see the module docstring);
    returns each rank's result in rank order, or raises."""
    import torch.distributed as dist

    from algebraicmultigrid_tpu_torch.parallel import make_row_mesh, run_ranks

    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"a process group of {dist.get_world_size()} ranks, not {n_devices}")
        return [_dryrun_rank(make_row_mesh(dist.get_backend(), device=device))]
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available: pass device='cpu' to run the ranks on the CPU")
    nccl = device is None and torch.cuda.device_count() >= n_devices
    return run_ranks(_dryrun_rank, n_devices, backend="nccl" if nccl else "gloo",
                     device=None if nccl else (device or "cuda"), timeout_s=timeout_s)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", [tuple(o.shape) for o in out], float(out[1]))
    for r in dryrun_multichip(max(2, torch.cuda.device_count())):
        print("dryrun ok:", r)
