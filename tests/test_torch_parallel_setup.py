"""PMIS splitting and label-propagation aggregation (the port's copy of
``models/parallel_setup.py``): splittings, aggregates and the hierarchies
built on them exactly equal to the JAX package's on the reference fixtures
(``tests/fixtures``) and on the problems of tests/test_parallel_setup.py.
Both algorithms are deterministic (a fixed golden-ratio hash breaks
ties), so equality is exact."""

import numpy as np
import pytest
import scipy.sparse as sp

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from conftest import load_csc

FIXTURES = ["randlap", "test", "thing", "onetoall", "lin_elastic_2d", "bug_graph"]
PROBLEMS = ["poisson2d", "randlap500", "elasticity-ish"]


def _matrix(name):
    """A fixture (CSC) or one of tests/test_parallel_setup.py's problems."""
    if name in FIXTURES:
        return load_csc(name)
    if name == "poisson2d":
        return sp.csc_matrix(amg.poisson((40, 40)))
    if name == "randlap500":
        n = 500
        M = sp.random(n, n, density=0.01, random_state=np.random.RandomState(4))
        G = sp.csr_matrix(M + M.T)
        return sp.csc_matrix(sp.csgraph.laplacian(G) + 0.05 * sp.eye(n))
    base = sp.csr_matrix(amg.poisson((20, 20)))
    return sp.kron(base, np.array([[2.0, 0.3], [0.3, 1.5]])).tocsc()


@pytest.mark.parametrize("name", FIXTURES + PROBLEMS)
def test_pmis_splitting_equals_jax(name):
    A = _matrix(name)
    S_j, _ = amg.Classical(0.25)(sp.csc_matrix(A).T.tocsc())
    S_t, _ = amt.Classical(0.25)(sp.csc_matrix(A).T.tocsc())
    assert (abs(sp.csc_matrix(S_j) - sp.csc_matrix(S_t)) > 0).nnz == 0
    want = amg.PMIS()(sp.csc_matrix(S_j))
    got = amt.PMIS()(sp.csc_matrix(S_t))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", FIXTURES + PROBLEMS)
def test_labelprop_aggregates_equal_jax(name):
    A = _matrix(name)
    S_j, _ = amg.SymmetricStrength(0.0)(sp.csc_matrix(A))
    S_t, _ = amt.SymmetricStrength(0.0)(sp.csc_matrix(A))
    want = sp.csr_matrix(amg.LabelPropAggregation()(sp.csc_matrix(S_j)))
    got = sp.csr_matrix(amt.LabelPropAggregation()(sp.csc_matrix(S_t)))
    assert got.shape == want.shape
    assert (abs(got - want) > 0).nnz == 0


@pytest.mark.parametrize("name", ["poisson2d", "randlap"])
def test_hierarchies_on_parallel_setup_equal_jax(name):
    """``ruge_stuben(A, CF=PMIS())`` and ``smoothed_aggregation(A,
    aggregate=LabelPropAggregation())`` give the JAX package's levels."""
    A = _matrix(name)
    pairs = [
        (amg.ruge_stuben(A, CF=amg.PMIS()), amt.ruge_stuben(A, CF=amt.PMIS())),
        (amg.smoothed_aggregation(A, aggregate=amg.LabelPropAggregation()),
         amt.smoothed_aggregation(A, aggregate=amt.LabelPropAggregation())),
    ]
    for ml_j, ml_t in pairs:
        assert len(ml_t) == len(ml_j) >= 2
        for Lj, Lt in zip(ml_j.levels, ml_t.levels):
            for M in ("A", "P", "R"):
                d = sp.csr_matrix(getattr(Lj, M)) - sp.csr_matrix(getattr(Lt, M))
                assert abs(d).max() <= 1e-14 * abs(sp.csr_matrix(getattr(Lj, M))).max(), M
