"""The port's BSG tier against the JAX package's: ``rcm_permutation`` and
``bsg_from_csr`` give identical arrays, and the plain ``bsg_spmv`` (the
CUDA kernel's plain PyTorch version, which the wrapper runs on CPU tensors)
agrees with the JAX ``bsg_spmv`` (its Pallas kernel in interpret mode, as
the JAX package runs it off a TPU) and with ``bsg_spmv_reference`` to
float32 relative 1e-5.  The matrix classes are those of
``tests/test_bsg.py``: RCM'd scrambled meshes, elasticity-like blocks, a
random graph Laplacian and a rectangular banded transfer operator."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
from algebraicmultigrid_tpu.ops import bsg as jbsg

from algebraicmultigrid_tpu_torch.ops import bsg as tbsg
from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
from algebraicmultigrid_tpu_torch.ops.kernels.bsg_spmv import bsg_spmv, bsg_spmv_reference

RTOL = 1e-5
FIELDS = ("data", "off", "m0", "qlo")
STATIC = ("shape", "nnz", "ws", "qb", "rows_padded", "cols_padded")


def _scrambled(A, seed):
    A = sp.csr_matrix(A)
    p = np.random.default_rng(seed).permutation(A.shape[0])
    return A[p][:, p].tocsr()


def _elasticity():
    base = sp.csr_matrix(amg.poisson((24, 24)))
    return _scrambled(sp.kron(base, np.array([[2.0, 0.3], [0.3, 1.5]])).tocsr(), 9)


def _random_laplacian():
    M = sp.random(100, 100, density=0.06, random_state=np.random.RandomState(2))
    return sp.csgraph.laplacian(sp.csr_matrix(M + M.T)).tocsr()


def _transfer():
    nf, nco = 3000, 1500
    rng = np.random.default_rng(3)
    rows = np.repeat(np.arange(nf), 3)
    cols = np.clip(rows // 2 + rng.integers(-40, 41, rows.shape[0]), 0, nco - 1)
    P = sp.coo_matrix((rng.standard_normal(rows.shape[0]), (rows, cols)), shape=(nf, nco)).tocsr()
    P.sum_duplicates()
    return P


MATRICES = {
    "poisson48": lambda: _scrambled(amg.poisson((48, 48)), 2),
    "poisson3d": lambda: _scrambled(amg.poisson((13, 11, 9)), 3),
    "elasticity": _elasticity,
    "randlap": _random_laplacian,
}


def _rcm(A):
    pi = jbsg.rcm_permutation(A)
    return A[pi][:, pi].tocsr()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_rcm_permutation_matches_jax(name):
    A = MATRICES[name]()
    pi_t = tbsg.rcm_permutation(A)
    assert np.array_equal(pi_t, jbsg.rcm_permutation(A))
    assert np.array_equal(np.sort(pi_t), np.arange(A.shape[0]))


def _pair(M, **kw):
    B_j = jbsg.bsg_from_csr(M, **kw)
    B_t = tbsg.bsg_from_csr(M, torch.float32, "cpu", **kw)
    assert B_j is not None and B_t is not None
    return B_j, B_t


@pytest.mark.parametrize("name", sorted(MATRICES) + ["transfer", "natural48"])
def test_bsg_arrays_and_spmv_match_jax(name):
    if name == "transfer":
        M, kw = _transfer(), {}
    elif name == "natural48":  # natural order under the lowering's window cap
        M, kw = _scrambled(amg.poisson((48, 48)), 1), dict(ws_cap=64)
    else:
        M, kw = _rcm(MATRICES[name]()), {}
    B_j, B_t = _pair(M, **kw)
    for f in STATIC:
        assert getattr(B_t, f) == getattr(B_j, f), f
    for f in FIELDS:
        assert np.array_equal(getattr(B_t, f).numpy(), np.asarray(getattr(B_j, f))), f

    n_rows, n_cols = M.shape
    x = np.random.default_rng(0).standard_normal(n_cols).astype(np.float32)
    xin = np.pad(x, (0, max(B_j.cols_padded, B_j.rows_padded) - n_cols))
    before = dict(vl.launches)
    y_t = bsg_spmv(B_t, torch.as_tensor(xin)).numpy()
    assert vl.launches == before  # a CPU tensor runs the plain version
    assert y_t.shape == (B_t.rows_padded,) and not y_t[n_rows:].any()
    y_j = np.asarray(jbsg.bsg_spmv(B_j, jnp.asarray(xin)))[:n_rows]
    y_ref = jbsg.bsg_spmv_reference(B_j, x)[:n_rows]
    scale = max(np.abs(y_ref).max(), 1.0)
    assert np.abs(y_t[:n_rows] - y_j).max() <= RTOL * scale
    assert np.abs(y_t[:n_rows] - y_ref).max() <= RTOL * scale
    y_sp = M.astype(np.float64) @ x.astype(np.float64)
    assert np.abs(y_t[:n_rows] - y_sp).max() <= RTOL * scale


def test_bsg_short_operand_reads_zero_guards():
    """x of exactly n_cols entries: the window past it reads zeros, as the
    JAX package's guard blocks do."""
    M = _rcm(MATRICES["poisson48"]())
    _, B_t = _pair(M)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(M.shape[1]).astype(np.float32))
    y = bsg_spmv_reference(B_t, x).numpy()[: M.shape[0]]
    assert np.abs(y - M @ x.double().numpy()).max() <= RTOL * np.abs(y).max()


def test_bsg_refuses_like_jax():
    A = _rcm(_scrambled(amg.poisson((32, 32)), 2))
    assert tbsg.bsg_from_csr(A, torch.float32, "cpu", ws_cap=4) is None
    assert jbsg.bsg_from_csr(A, ws_cap=4) is None
    assert tbsg.bsg_from_csr(A, torch.float64, "cpu") is None  # float32 only
    dense_row = sp.lil_matrix((2048, 2048))
    dense_row[0, :100] = 1.0
    M = sp.csr_matrix(dense_row) + sp.eye(2048)
    assert tbsg.bsg_from_csr(M, torch.float32, "cpu", K_cap=64) is None
    wide = sp.csr_matrix(sp.eye(20000) + sp.diags(np.ones(19000), 1000))
    r = sp.lil_matrix((20000, 20000))
    r[0, :40] = 1.0
    M2 = (wide + sp.csr_matrix(r)).tocsr()
    assert tbsg.bsg_from_csr(M2, torch.float32, "cpu", max_overhead=3.0) is None
    assert jbsg.bsg_from_csr(M2, max_overhead=3.0) is None


def test_bsg_spmv_checks_its_operand():
    _, B_t = _pair(_rcm(MATRICES["poisson48"]()))
    with pytest.raises(TypeError):
        bsg_spmv(B_t, torch.zeros(B_t.rows_padded, dtype=torch.float64))
    with pytest.raises(ValueError):
        bsg_spmv(B_t, torch.zeros(B_t.shape[1] - 1))
