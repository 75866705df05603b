"""Multi-RHS (``x[n, k]``) device paths of the port against the JAX package,
which takes a 2-D x in every SpMV, smoother and driver: the case of
``tests/test_solve.py::test_multi_rhs`` through ``ml.solve(B,
engine="torch")`` (atol 1e-6, as the JAX test asserts for ``engine="jax"``),
each device format's SpMV on [n, 2] against the same SpMV column by column
(bitwise: the per-column arithmetic is unchanged; Dense to 1e-14, where BLAS
sums a matrix-matrix product in another order than a matrix-vector one), and
one cycle with a 2-D x through the gathered multicolor and the Jacobi
smoothers against the JAX ``_one_iteration`` in float64 to 1e-10.  The
lattice cycles (legs and tail, K5, K7) are in
``test_torch_multi_rhs_cycles.py``."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from algebraicmultigrid_tpu_torch.ops import banded as tb
from algebraicmultigrid_tpu_torch.ops import sparse as ts

from torch_port_common import K, SETUP_KW, rel_err, rhs_block as _block, multi_rhs_cycles as _cycle_pair

@pytest.fixture(scope="module")
def rs400():
    A = amg.poisson(400)
    X = np.stack([np.ones(400), np.linspace(0, 1, 400)], axis=1)
    return A, X, amg.ruge_stuben(A), amt.ruge_stuben(A)


def test_multi_rhs_solve_matches_jax(rs400):
    A, X, ml_j, ml_t = rs400
    B = A @ X
    xd_j = ml_j.solve(B, engine="jax", reltol=1e-10)
    xd_t = ml_t.solve(B, engine="torch", reltol=1e-10, device="cpu")
    assert xd_t.shape == X.shape
    assert np.allclose(xd_t, X, atol=1e-6)
    assert np.allclose(xd_t, xd_j, atol=1e-6)


def test_multi_rhs_drivers(rs400):
    """``solve_device`` on its logged path, ``cg_device`` (a block is one
    vector of the block-diagonal system, as ``jnp.vdot`` takes it) and
    ``device_cycle_fn`` take B [n, 2]; each column of one cycle equals the
    cycle of that column alone, up to the dense coarse solve's matrix-matrix
    against matrix-vector product (BLAS sums them in another order)."""
    from algebraicmultigrid_tpu.models.device import cg_device as cg_j

    A, X, ml_j, ml_t = rs400
    B = A @ X
    x_log, res = amt.solve_device(ml_t, B, reltol=1e-10, log=True, device="cpu")
    assert np.allclose(x_log, X, atol=1e-6) and res[-1] < 1e-10 * res[0]
    x_cg, it_t, _ = amt.cg_device(ml_t, B, tol=1e-10, log=True, device="cpu")
    _, it_j, _ = cg_j(ml_j, B, tol=1e-10, log=True)
    assert np.allclose(x_cg, X, atol=1e-6) and it_t == it_j
    apply = amt.device_cycle_fn(ml_t, device="cpu", dtype=torch.float64)
    both = apply(B)
    for j in range(K):
        assert rel_err(both[:, j], apply(B[:, j])) < 1e-13


def _formats():
    """One operator of every device format, by name."""
    from algebraicmultigrid_tpu_torch.ops.bsg import bsg_from_csr
    from algebraicmultigrid_tpu_torch.ops.lattice_nd_op import latnd_from_spec
    from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec

    ml2 = amt.structured_smoothed_aggregation(
        amt.poisson((192, 192), lattice=True), aggregate=amt.StructuredAggregation(box=3), **SETUP_KW
    )
    L0 = ml2.levels[0]
    sa = amt.smoothed_aggregation(sp.csr_matrix(amt.poisson((24, 24))))
    rs = amt.ruge_stuben(sp.csr_matrix(amt.poisson((24, 24))))
    f64 = torch.float64
    ops = {
        "lat2d_A": lat2d_from_spec(L0.A.spec, f64, "cpu", row_pad=8),
        "lat2d_P": lat2d_from_spec(L0.P.spec, f64, "cpu", row_pad=8),
        "lat2d_R": lat2d_from_spec(L0.R.spec, f64, "cpu", row_pad=8),
        "latnd_A": latnd_from_spec(amt.poisson((6, 5, 4), lattice=True).spec, f64, "cpu"),
        "sdia_A": tb.sdia_from_csr(sp.csr_matrix(sa.levels[0].A), f64, "cpu"),
        "sdia_R": tb.sdia_from_csr(sp.csr_matrix(rs.levels[0].R), f64, "cpu"),
        "bt_A": tb.bt_from_csr(sp.csr_matrix(rs.levels[0].A), f64, "cpu"),
        "dense_A": tb.dense_from_csr(sp.csr_matrix(sa.levels[1].A), f64, "cpu"),
        "ell_P": ts.ell_from_csr(sp.csr_matrix(sa.levels[0].P), f64, "cpu"),
        "bsg_A": bsg_from_csr(sp.csr_matrix(sa.levels[0].A), torch.float32, "cpu"),
    }
    return ops


_OPS = {}


@pytest.mark.parametrize(
    "name", ["lat2d_A", "lat2d_P", "lat2d_R", "latnd_A", "sdia_A", "sdia_R", "bt_A", "dense_A", "ell_P", "bsg_A"]
)
def test_spmv_multi_rhs_equals_columns(name):
    from algebraicmultigrid_tpu_torch.ops.bsg import BSG
    from algebraicmultigrid_tpu_torch.ops.lattice_nd_op import LatND
    from algebraicmultigrid_tpu_torch.ops.lattice_op import Lat2D

    if not _OPS:
        _OPS.update(_formats())
    op = _OPS[name]
    assert op is not None, f"{name}: the builder refused the operator"
    kinds = {"lat2d": Lat2D, "latnd": LatND, "sdia": tb.SDIA, "bt": tb.BTOp, "dense": tb.DenseOp,
             "ell": ts.ELL, "bsg": BSG}
    assert isinstance(op, kinds[name.split("_")[0]])
    n_cols = op.shape[1]
    X = _block(n_cols, pad=5, seed=1, dtype=torch.float32 if name == "bsg_A" else torch.float64)
    Y = tb.mat_vec(op, X)
    cols = torch.stack([tb.mat_vec(op, X[:, j].contiguous()) for j in range(K)], dim=1)
    assert Y.shape == cols.shape and Y.shape[0] >= op.shape[0]
    if name == "dense_A":
        assert rel_err(Y, cols) < 1e-14
    else:
        assert torch.equal(Y, cols)


def test_whole_sweep_without_fallback_refuses_a_block():
    """A K5 cache built with no masked fallback raises on a 2-D x instead of
    running some other smoother."""
    from algebraicmultigrid_tpu_torch.models.device import _apply_smoother
    from algebraicmultigrid_tpu_torch.models.lattice import lattice_coloring
    from algebraicmultigrid_tpu_torch.ops.kernels.gs_sweep import build_gs_sweep_cache
    from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec

    spec = amt.poisson((16, 12), lattice=True).spec
    A = lat2d_from_spec(spec, torch.float64, "cpu", row_pad=8)
    dinv = torch.zeros(A.rows_padded, dtype=torch.float64)
    dinv[: 16 * 12] = torch.as_tensor(1.0 / spec.diagonal())
    grid, nc = lattice_coloring(spec)
    cache = build_gs_sweep_cache(A, dinv, grid, nc, 1.0, 1, True, True)
    X = _block(16 * 12, pad=A.rows_padded - 16 * 12)
    with pytest.raises(ValueError, match="no masked fallback"):
        _apply_smoother(cache, A, X, X)


@pytest.mark.parametrize("smoother", ["multicolor", "jacobi"])
def test_cycle_multi_rhs_general_smoothers(smoother):
    """The gathered multicolor sweep (ELL levels) and Jacobi on a block,
    against the JAX ``_one_iteration``: SA on a scrambled 48² Poisson in
    float64 (above the dense limit; BSG takes float32 only, so the fine
    level is ELL)."""
    from algebraicmultigrid_tpu_torch.models.device import JacobiCache, MulticolorCache
    from torch_port_common import scrambled_poisson

    A = scrambled_poisson(48)
    pair = []
    for pkg in (amg, amt):
        sm = pkg.GaussSeidel(ordering="multicolor") if smoother == "multicolor" else pkg.Jacobi(0.7, iter=2)
        pair.append(pkg.smoothed_aggregation(A, presmoother=sm, postsmoother=sm))
    h_t, got, want = _cycle_pair(*pair, A.shape[0], 5)
    kind = MulticolorCache if smoother == "multicolor" else JacobiCache
    assert isinstance(h_t.levels[0].pre, kind) and isinstance(h_t.levels[0].A, ts.ELL)
    assert rel_err(got, want) < 1e-10
