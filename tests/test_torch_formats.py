"""The port's general device formats against the JAX package's: the ELL,
SDIA, block-Toeplitz and dense builders give the same arrays, and
``mat_vec`` over each format agrees with the JAX ``mat_vec`` in float64 to
1e-12 (relative, max-abs).  The matrices are transfer and level operators
of small Poisson hierarchies, picked so that every builder branch runs:
unit and rational strides p/q (with q = 2 and 3, the residue interleave),
a block-Toeplitz operator with and without a boundary remainder, and a
gather-only ELL operator."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
from algebraicmultigrid_tpu.ops import banded as jb
from algebraicmultigrid_tpu.ops import sparse as js

from algebraicmultigrid_tpu_torch.ops import banded as tb
from algebraicmultigrid_tpu_torch.ops import sparse as ts

from torch_port_common import rel_err

TOL = 1e-12


def _hierarchies():
    sa = amg.smoothed_aggregation(sp.csr_matrix(amg.poisson((24, 24))))
    rs2 = amg.ruge_stuben(sp.csr_matrix(amg.poisson((24, 24))))
    rs1 = amg.ruge_stuben(sp.csr_matrix(amg.poisson((32,))))
    return {"sa": sa, "rs2": rs2, "rs1": rs1}


_ML = {}


def _matrix(name):
    """(hierarchy, level, operator) → the scipy matrix."""
    if not _ML:
        _ML.update(_hierarchies())
    which, lvl, op = name.split(":")
    return sp.csr_matrix(getattr(_ML[which].levels[int(lvl)], op))


SDIA_CASES = ["sa:0:A", "sa:1:P", "sa:1:R", "rs2:0:P", "rs2:0:R", "rs2:3:R", "rs1:0:P"]
BT_CASES = ["sa:0:A", "rs2:0:A", "rs1:0:P", "rs1:0:R"]
DENSE_CASES = ["sa:1:A", "rs2:2:P", "rs2:3:R"]
ELL_CASES = ["sa:0:P", "sa:0:R", "rs2:1:R"]


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def _mat_vecs(op_j, op_t, M, pad=0):
    """(JAX y, port y, scipy y) in float64 at the logical rows."""
    n_rows, n_cols = M.shape
    x = np.concatenate([_x(n_cols), np.zeros(pad)])
    y_j = np.asarray(jb.mat_vec(op_j, jnp.asarray(x)))[:n_rows]
    y_t = tb.mat_vec(op_t, torch.as_tensor(x)).numpy()[:n_rows]
    return y_j, y_t, M @ x[:n_cols]


@pytest.mark.parametrize("name", SDIA_CASES)
def test_sdia_matches_jax(name):
    M = _matrix(name)
    kw = dict(max_offsets=96, max_overhead=8.0)
    S_j = jb.sdia_from_csr(M, dtype=jnp.float64, **kw)
    S_t = tb.sdia_from_csr(M, torch.float64, "cpu", **kw)
    assert S_j is not None and S_t is not None
    assert (S_t.offsets, S_t.p, S_t.q, S_t.shape, S_t.nnz, S_t.rows_padded) == (
        S_j.offsets, S_j.p, S_j.q, S_j.shape, S_j.nnz, S_j.rows_padded
    )
    assert np.array_equal(S_t.data.numpy(), np.asarray(S_j.data))
    y_j, y_t, y_s = _mat_vecs(S_j, S_t, M)
    assert rel_err(y_t, y_j) < TOL and rel_err(y_t, y_s) < TOL


@pytest.mark.parametrize("name", BT_CASES)
def test_bt_matches_jax(name):
    M = _matrix(name)
    B_j = jb.bt_from_csr(M, dtype=jnp.float64)
    B_t = tb.bt_from_csr(M, torch.float64, "cpu")
    assert B_j is not None and B_t is not None
    assert (B_t.deltas, B_t.T, B_t.C, B_t.shape, B_t.nnz, B_t.rows_padded) == (
        B_j.deltas, B_j.T, B_j.C, B_j.shape, B_j.nnz, B_j.rows_padded
    )
    for f in ("blocks", "rest_rows", "rest_data", "rest_cols"):
        assert np.array_equal(getattr(B_t, f).numpy(), np.asarray(getattr(B_j, f))), f
    y_j, y_t, y_s = _mat_vecs(B_j, B_t, M)
    assert rel_err(y_t, y_j) < TOL and rel_err(y_t, y_s) < TOL


@pytest.mark.parametrize("name", DENSE_CASES)
def test_dense_matches_jax(name):
    M = _matrix(name)
    D_j = jb.dense_from_csr(M, dtype=jnp.float64)
    D_t = tb.dense_from_csr(M, torch.float64, "cpu")
    assert (D_t.shape, D_t.nnz, D_t.rows_padded) == (D_j.shape, D_j.nnz, D_j.rows_padded)
    assert np.array_equal(D_t.mat.numpy(), np.asarray(D_j.mat))
    y_j, y_t, y_s = _mat_vecs(D_j, D_t, M, pad=5)
    assert rel_err(y_t, y_j) < TOL and rel_err(y_t, y_s) < TOL


@pytest.mark.parametrize("name", ELL_CASES)
def test_ell_matches_jax(name):
    M = _matrix(name)
    E_j = js.ell_from_csr(M, dtype=jnp.float64)
    E_t = ts.ell_from_csr(M, torch.float64, "cpu")
    assert (E_t.shape, E_t.nnz, E_t.rows_padded, E_t.width) == (E_j.shape, E_j.nnz, E_j.rows_padded, E_j.width)
    assert np.array_equal(E_t.data.numpy(), np.asarray(E_j.data))
    assert np.array_equal(E_t.cols.numpy(), np.asarray(E_j.cols))
    assert (ts.ell_to_scipy(E_t) != js.ell_to_scipy(E_j)).nnz == 0
    y_j, y_t, y_s = _mat_vecs(E_j, E_t, M, pad=3)
    assert rel_err(y_t, y_j) < TOL and rel_err(y_t, y_s) < TOL


def test_builders_refuse_alike():
    """Where the JAX builders return None, so do the port's."""
    M = _matrix("sa:0:P")  # unstructured aggregates: no stride, no period
    assert jb.sdia_from_csr(M, dtype=jnp.float64) is None
    assert tb.sdia_from_csr(M, torch.float64, "cpu") is None
    assert jb.bt_from_csr(M, dtype=jnp.float64) is None
    assert tb.bt_from_csr(M, torch.float64, "cpu") is None


def test_mat_vec_rejects_unknown_formats():
    with pytest.raises(TypeError):
        tb.mat_vec(object(), torch.zeros(3))
