"""The port's ``solve`` / ``ml.solve`` on the torch engine (``device="cpu"``)
against the JAX package's ``engine="jax"`` on the cases of ROADMAP A4 that
need other smoothers, a user-built hierarchy or other dtypes: SA with
Jacobi and with multicolor SOR smoothing (equal iteration counts, float64
residual histories to 1e-10 relative), test_gmg_extension.py's geometric
multigrid on poisson(2¹⁰) built from the public ``Level``/``MultiLevel``
(27 = 27 residuals to reltol 1e-10), and test_precision.py's poisson(100)
SA with (A, b) in float32/float64, float64/float32 and float32/float32:
both device engines solve in the matrix's dtype (ROADMAP C, reference
behaviours), and the port's relative residual is the JAX package's to
within a factor of 2."""

import numpy as np
import pytest
import scipy.sparse as sp

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from test_gmg_extension import _linear_interp_P

TOL64 = 1e-10
SMOOTHERS = {
    "jacobi": lambda pkg: pkg.Jacobi(0.7, iter=2),
    "sor": lambda pkg: pkg.SOR(0.8, pkg.SymmetricSweep(), iter=2, ordering="multicolor"),
}


def _hist_close(r_t, r_j, tol=TOL64):
    r_t, r_j = np.asarray(r_t), np.asarray(r_j)
    assert r_t.shape == r_j.shape
    assert np.max(np.abs(r_t - r_j)) <= tol * r_j[0]


@pytest.mark.parametrize("smoother,iters", [("jacobi", 13), ("sor", 8)])
def test_sa_smoothers_match_jax_engine(smoother, iters):
    A = amg.poisson((20, 20))
    b = A @ np.ones(A.shape[0])
    sj, st = SMOOTHERS[smoother](amg), SMOOTHERS[smoother](amt)
    xj, rj = amg.solve(A, b, amg.SmoothedAggregationAMG(), presmoother=sj, postsmoother=sj, engine="jax",
                       reltol=1e-8, log=True)
    xt, rt = amt.solve(A, b, amt.SmoothedAggregationAMG(), presmoother=st, postsmoother=st, engine="torch",
                       device="cpu", reltol=1e-8, log=True)
    assert len(rt) == len(rj) == iters
    _hist_close(rt, rj)
    assert np.abs(xt - xj).max() < 1e-10


def _gmg(pkg, A, max_levels=10, max_coarse=10):
    """test_gmg_extension.py's ``geometric_multigrid`` on ``pkg``'s public
    ``Level``/``MultiLevel`` and its host smoother setup."""
    from importlib import import_module

    setup_smoother_host = import_module(f"{pkg.__name__}.models.relax").setup_smoother_host
    smoother = pkg.GaussSeidel()
    A = sp.csr_matrix(A)
    levels = []
    while len(levels) + 1 < max_levels and A.shape[0] > max_coarse:
        P = _linear_interp_P(A.shape[0])
        R = sp.csr_matrix(P.T)
        pre = setup_smoother_host(smoother, A, pkg.HermitianSymmetry())
        post = setup_smoother_host(smoother, A, pkg.HermitianSymmetry())
        levels.append(pkg.Level(A=A, P=P, R=R, presmoother=pre, postsmoother=post,
                                presmoother_config=smoother, postsmoother_config=smoother))
        A = sp.csr_matrix(R @ A @ P)
    return pkg.MultiLevel(levels, A, pkg.Pinv(A))


def test_user_built_gmg_hierarchy_matches_jax_engine():
    A = amg.poisson(2**10)
    b = A @ np.ones(A.shape[0])
    ml_j, ml_t = _gmg(amg, A), _gmg(amt, A)
    assert len(ml_t) == len(ml_j)
    xj, rj = ml_j.solve(b, engine="jax", reltol=1e-10, log=True)
    xt, rt = ml_t.solve(b, engine="torch", device="cpu", reltol=1e-10, log=True)
    assert len(rt) == len(rj) == 27
    _hist_close(rt, rj)
    assert rt[-1] <= 1e-10 * rt[0] and np.abs(xt - 1).max() < 1e-6


@pytest.mark.parametrize("T,V", [(np.float32, np.float64), (np.float64, np.float32), (np.float32, np.float32)])
def test_precision_pairs_match_jax_engine(T, V):
    a = amg.poisson(100).astype(T)
    b = np.random.default_rng(0).random(a.shape[0]).astype(V)
    ml_j, ml_t = amg.smoothed_aggregation(a), amt.smoothed_aggregation(a)
    xj = np.asarray(ml_j.solve(b, engine="jax"))
    xt = ml_t.solve(b, engine="torch", device="cpu")
    assert xt.dtype == xj.dtype == np.dtype(T)
    rel = lambda x: np.linalg.norm((a @ x - b).astype(np.float64)) / np.linalg.norm(b.astype(np.float64))
    rj, rt = rel(xj), rel(xt)
    assert rt <= 2 * rj + 1e-14 and rj <= 2 * rt + 1e-14, (rt, rj)
