"""The plain reference: its operator, its agreement with a direct solve, and
its controls at a small size (the reference in the precision below the
configuration's fails the limit; at the configuration's own it meets it)."""

import json
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from amgbench.reference import poisson

LIMITS = Path(__file__).resolve().parents[1] / "limits"


def laplacian(nx, ny):
    """The 5-point Dirichlet Laplacian built from 1-D second differences."""
    def d2(m):
        return sp.diags([-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)], [-1, 0, 1])

    return (sp.kron(d2(nx), sp.identity(ny)) + sp.kron(sp.identity(nx), d2(ny))).tocsr()


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


def test_reference_agrees_with_a_direct_solve():
    dims = (32, 32)
    b = torch.randn(32 * 32, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
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
