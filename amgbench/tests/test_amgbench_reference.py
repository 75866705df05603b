"""The plain reference: its operator on grids of one, two and three
dimensions, its agreement with a direct solve, and its controls at a small
size (the reference in the precision below the configuration's fails the
limit; at the configuration's own it meets it)."""

import json
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from amgbench.reference import poisson

LIMITS = Path(__file__).resolve().parents[1] / "limits"


def laplacian(*dims):
    """The 2·d-point Dirichlet Laplacian on a grid of d dimensions, the
    Kronecker sum of 1-D second differences, the last axis fastest."""
    def d2(m):
        return sp.diags([-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)], [-1, 0, 1])

    total = None
    for axis, m in enumerate(dims):
        before, after = sp.identity(int(np.prod(dims[:axis]))), sp.identity(int(np.prod(dims[axis + 1:])))
        term = sp.kron(sp.kron(before, d2(m)), after)
        total = term if total is None else total + term
    return total.tocsr()


def frozen_2d_apply(x, dims):
    """The 2-D operator as the reference computed it before it took grids of
    any dimension, kept as written: the 2-D cells' readings must not move."""
    nx, ny = dims
    X = x.reshape(*x.shape[:-1], nx, ny)
    Y = 4 * X
    Y[..., 1:, :] -= X[..., :-1, :]
    Y[..., :-1, :] -= X[..., 1:, :]
    Y[..., :, 1:] -= X[..., :, :-1]
    Y[..., :, :-1] -= X[..., :, 1:]
    return Y.reshape(x.shape)


@pytest.mark.parametrize("dims", [(7, 7), (12, 5)])
def test_operator_is_the_5_point_laplacian(dims):
    u = torch.randn(2, dims[0] * dims[1], dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    want = (laplacian(*dims) @ u.numpy().T).T
    np.testing.assert_allclose(poisson.apply(u, dims).numpy(), want, rtol=0, atol=1e-13)  # summation order apart


def test_operator_is_the_programs_gallery_operator():
    import algebraicmultigrid_tpu_torch as amt

    n = 9
    u = torch.randn(n * n, dtype=torch.float64, generator=torch.Generator().manual_seed(4))
    want = amt.poisson((n, n)).tocsr() @ u.numpy()
    np.testing.assert_allclose(poisson.apply(u, (n, n)).numpy(), want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("dims", [(6, 5, 4), (7, 7, 7), (11,), (3, 4, 2, 5)])
def test_operator_is_the_kronecker_sum_laplacian(dims):
    n = int(np.prod(dims))
    u = torch.randn(2, n, dtype=torch.float64, generator=torch.Generator().manual_seed(7))
    want = (laplacian(*dims) @ u.numpy().T).T
    np.testing.assert_allclose(poisson.apply(u, dims).numpy(), want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("dims", [(6, 5, 4), (7, 7, 7)])
def test_3d_operator_is_the_programs_gallery_and_lattice_operator(dims):
    """The program's lattice operator (``LatND``, the layout its 3-D levels
    hold x in) and its assembled gallery operator, at uneven dims so that an
    axis taken in the wrong order shows.  The assembled gallery numbers the
    grid column-major (Julia's ``LinearIndices``), so it is the same matrix
    on the grid's axes reversed."""
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.ops.banded import mat_vec
    from algebraicmultigrid_tpu_torch.ops.lattice_nd_op import latnd_from_spec

    n = int(np.prod(dims))
    u = torch.randn(n, dtype=torch.float64, generator=torch.Generator().manual_seed(8))
    got = poisson.apply(u, dims).numpy()
    lat = latnd_from_spec(amt.poisson(dims, lattice=True).spec, torch.float64, "cpu")
    assert lat.row_dims == dims
    np.testing.assert_allclose(got, mat_vec(lat, u)[:n].numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(got, amt.poisson(dims[::-1]).tocsr() @ u.numpy(), rtol=0, atol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dims", [(7, 7), (12, 5), (1, 9), (64, 48)])
def test_2d_operator_is_bitwise_the_frozen_formula(dims, dtype):
    u = torch.randn(3, dims[0] * dims[1], dtype=dtype, generator=torch.Generator().manual_seed(9))
    assert torch.equal(poisson.apply(u, dims), frozen_2d_apply(u, dims))
    assert torch.equal(poisson.apply(u[1], dims), frozen_2d_apply(u[1], dims))


@pytest.mark.parametrize("dims", [(32, 32), (16, 16, 16)])
def test_reference_agrees_with_a_direct_solve(dims):
    n = int(np.prod(dims))
    b = torch.randn(n, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    x, steps = poisson.cg(b, dims, torch.float64, 1e-12, 10_000)
    direct = spla.spsolve(laplacian(*dims).tocsc(), b.numpy())
    assert np.abs(x.numpy() - direct).max() <= 1e-9 * np.abs(direct).max()
    assert poisson.relres(x, b, dims) <= 1e-12 and 0 < steps < 10_000


@pytest.mark.parametrize("cell", ["flagship-solve", "reloaded-solve", "flagship-cycles"])
def test_control_fails_and_reference_meets_the_limit(cell):
    """At 256²: the control (the reference's CG in the precision below the
    configuration's, its stopping rule from the cell's limits file) reads
    above the limit; the reference at the configuration's precision under."""
    limits = json.loads((LIMITS / f"{cell}.json").read_text())
    control, limit = limits["control"], limits["checks"]["relres_max"]["limit"]
    dims = (256, 256)
    gen = torch.Generator().manual_seed(6)
    b = torch.randn(dims[0] * dims[1], dtype=torch.float64, generator=gen)
    lower, _ = poisson.cg(b, dims, getattr(torch, control["dtype"]), control["tol"], 3000)
    assert poisson.relres(lower, b, dims) > limit
    own, _ = poisson.cg(b, dims, getattr(torch, control["reference_dtype"]), control["tol"], control["maxiter"])
    assert poisson.relres(own, b, dims) <= limit
