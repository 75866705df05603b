"""The port's native setup tier (``native/amg_setup.cpp``) against the JAX
package's: the library builds and loads, and ``graph_coloring``,
``aggregate_ids`` and ``rs_cf_splitting`` give exactly the JAX package's
answers.  With the coloring equal, the host multicolor GS smoother colors a
general graph as the JAX package does, so its sweeps agree in float64 to
1e-12 (with a Jones-Plassmann coloring they did not).  A library that
cannot be built raises: no other tier takes over."""

import numpy as np
import pytest
import scipy.sparse as sp

import algebraicmultigrid_tpu as amg
from algebraicmultigrid_tpu.models import aggregate as jagg
from algebraicmultigrid_tpu.models import splitting as jsplit
from algebraicmultigrid_tpu.ops import coloring as jcol

import algebraicmultigrid_tpu_torch as amt
from algebraicmultigrid_tpu_torch.models import aggregate as tagg
from algebraicmultigrid_tpu_torch.models import splitting as tsplit
from algebraicmultigrid_tpu_torch.models.strength import Classical, SymmetricStrength
from algebraicmultigrid_tpu_torch.native import build
from algebraicmultigrid_tpu_torch.native.build import get_native, library_path
from algebraicmultigrid_tpu_torch.ops import coloring as tcol

from conftest import load_csc


def _scrambled(n, seed=1):
    A = sp.csr_matrix(amg.poisson((n, n)))
    p = np.random.default_rng(seed).permutation(A.shape[0])
    return A[p][:, p].tocsr()


MATRICES = {
    "scrambled40": lambda: _scrambled(40),
    "randlap": lambda: load_csc("randlap"),
    "elasticity": lambda: load_csc("lin_elastic_2d"),
    "thing": lambda: load_csc("thing"),
}


def test_native_library_loads():
    """A failed g++ build would switch the port to another coloring; it
    must not pass unseen."""
    assert get_native() is not None
    assert library_path().exists()
    assert library_path().parent.name == "_build"


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source g++ refuses gives a RuntimeError with the compiler's
    message, and so does every setup routine that needs the library."""
    bad = tmp_path / "amg_setup.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "_SRC", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ could not build amg_setup.cpp"):
        get_native()
    with pytest.raises(RuntimeError):
        tcol.graph_coloring(MATRICES["scrambled40"]())


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("sym", [False, True])
def test_graph_coloring_matches_jax(name, sym):
    A = sp.csr_matrix(MATRICES[name]())
    c_t = tcol.graph_coloring(A, assume_symmetric=sym)
    assert np.array_equal(c_t, jcol.graph_coloring(A, assume_symmetric=sym))
    G = (A + A.T).tocsr()
    rows = np.repeat(np.arange(A.shape[0]), np.diff(G.indptr))
    off = rows != G.indices
    if not sym or (A != A.T).nnz == 0:
        assert not np.any(c_t[rows[off]] == c_t[G.indices[off]])


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_aggregate_ids_match_jax(name):
    S, _ = SymmetricStrength()(sp.csc_matrix(MATRICES[name]()))
    x_t, n_t = tagg.aggregate_ids(S)
    x_j, n_j = jagg.aggregate_ids(S)
    assert n_t == n_j and np.array_equal(x_t, x_j)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_rs_cf_splitting_matches_jax(name):
    S, T = Classical(0.25)(sp.csc_matrix(MATRICES[name]()))
    S = tsplit._remove_diag(S)
    T = sp.csc_matrix(S.T)
    got = tsplit.rs_cf_splitting(S, T)
    assert np.array_equal(got, jsplit.rs_cf_splitting(S, T))
    assert np.array_equal(tsplit.RS()(S), jsplit.RS()(S))


def test_host_multicolor_gs_matches_jax_float64():
    """The coloring fault: the host multicolor GS of ``models/relax.py``
    on a scrambled Poisson, the same cycles in both packages."""
    A = _scrambled(40)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    out = []
    for pkg in (amg, amt):
        gs = pkg.GaussSeidel(ordering="multicolor")
        ml = pkg.smoothed_aggregation(A, presmoother=gs, postsmoother=gs)
        out.append(ml.solve(b, maxiter=3, calculate_residual=False))
    assert np.abs(out[1] - out[0]).max() <= 1e-12 * np.abs(out[0]).max()
