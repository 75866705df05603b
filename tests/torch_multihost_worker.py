"""One rank of the two-launcher test (tests/test_torch_multihost.py), started
by ``torchrun --nnodes=2 --nproc-per-node=2``: it joins the group through
``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` as the launcher sets them), solves the
216² lattice of tests/_multihost_worker.py with ``solve_lattice_sharded``
across the seam between the launchers, runs one ``solve_sharded`` step on
the 32² RS problem, and prints one ``MULTIHOST_OK`` line."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.parallel import make_row_mesh, solve_lattice_sharded, solve_sharded

    mesh = make_row_mesh("gloo", device="cpu", init_method="env://")
    assert (mesh.rank, mesh.n_sh) == (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]))
    N = 216
    LP = amt.poisson((N, N), lattice=True)
    ml = amt.structured_smoothed_aggregation(
        LP, proxy=72, cut_rows=2000, min_proxy_dim=16, aggregate=amt.StructuredAggregation(box=3),
    )
    b = ml.levels[0].A @ np.ones(N * N)
    x, iters, relres = solve_lattice_sharded(ml, b, mesh=mesh, tol=1e-6, maxiter=40, log=True)
    assert relres < 1e-6, (iters, relres)
    err = float(np.linalg.norm(x - 1.0) / np.sqrt(N * N))
    assert err < 1e-4, err

    gs = amt.GaussSeidel(ordering="multicolor")
    A = amt.poisson((32, 32))
    mlr = amt.ruge_stuben(A, presmoother=gs, postsmoother=gs)
    xr, it1, nr1 = solve_sharded(mlr, A @ np.ones(A.shape[0]), mesh=mesh, maxiter=1, replicate_below=256)
    assert xr.shape == (A.shape[0],) and np.isfinite(nr1) and it1 == 1
    # the line and its newline in one write: ranks under one launcher share a pipe
    sys.stdout.write(f"MULTIHOST_OK rank={mesh.rank} local_rank={os.environ['LOCAL_RANK']} iters={iters}"
                     f" relres={relres:.3e} err={err:.3e} sharded_step_res={nr1:.6e}\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
