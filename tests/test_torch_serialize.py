"""Hierarchy checkpoints across the two packages (the port's copy of
``utils/serialize.py``, format and all): a file written by either package
loads in the other with identical matrices, smoother configs, symmetry
and coarse solver; a loaded structured-SA hierarchy, which carries no
factored-prolongator stash, lowers to the non-factored R/P-plane legs and
tail in both packages and cycles like the original."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from torch_port_common import PLAIN_TILES, jax_env, setup_both

PKGS = {"jax": amg, "torch": amt}


def _same_matrix(a, b):
    """Identical operators: equal lattice specs (table bitwise), or equal
    CSR triples."""
    lattice = ("LatticeMatrix", "LatticeProblem")
    if type(a).__name__ in lattice:
        assert type(b).__name__ in lattice
        sa, sb = a.spec, b.spec
        assert tuple(map(tuple, sa.offsets)) == tuple(map(tuple, sb.offsets))
        assert tuple(sa.row_dims) == tuple(sb.row_dims) and tuple(sa.col_dims) == tuple(sb.col_dims)
        assert (sa.Kx, sa.sx, sa.Ky, sa.sy) == (sb.Kx, sb.sx, sb.Ky, sb.sy)
        assert (tuple(sa.base_x), tuple(sa.base_y)) == (tuple(sb.base_x), tuple(sb.base_y))
        assert sa.table.dtype == sb.table.dtype and np.array_equal(sa.table, sb.table)
        return
    A, B = sp.csr_matrix(a), sp.csr_matrix(b)
    assert A.shape == B.shape and A.dtype == B.dtype
    assert np.array_equal(A.indptr, B.indptr) and np.array_equal(A.indices, B.indices)
    assert np.array_equal(A.data, B.data)


def _same_hierarchy(ml_a, ml_b):
    assert len(ml_a.levels) == len(ml_b.levels)
    assert type(ml_a.symmetry).__name__ == type(ml_b.symmetry).__name__
    assert type(ml_a.coarse_solver).__name__ == type(ml_b.coarse_solver).__name__
    for La, Lb in zip(ml_a.levels, ml_b.levels):
        for M in ("A", "P", "R"):
            _same_matrix(getattr(La, M), getattr(Lb, M))
        for cfg in ("presmoother_config", "postsmoother_config"):
            assert repr(getattr(La, cfg)) == repr(getattr(Lb, cfg))
    _same_matrix(ml_a.final_A, ml_b.final_A)


@pytest.fixture(scope="module")
def lattice():
    """The 192² structured-SA hierarchies (default, factored) of both
    packages."""
    return setup_both()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_generic_file_loads_in_the_other_package(tmp_path, writer, reader):
    w, r = PKGS[writer], PKGS[reader]
    A = amg.poisson((40, 40))
    ml = w.ruge_stuben(A, presmoother=w.SOR(0.9, w.ForwardSweep(), iter=2), postsmoother=w.Jacobi(0.6))
    p = str(tmp_path / "h.npz")
    w.save_hierarchy(ml, p)
    ml_r, ml_w = r.load_hierarchy(p), w.load_hierarchy(p)
    _same_hierarchy(ml_r, ml_w)
    _same_hierarchy(ml_r, ml)
    b = A @ np.ones(A.shape[0])
    x1, r1 = w.solve_mg(ml_w, b, reltol=1e-8, log=True)
    x2, r2 = r.solve_mg(ml_r, b, reltol=1e-8, log=True)
    assert len(r1) == len(r2) and np.allclose(x1, x2, rtol=0, atol=1e-14)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_lattice_file_loads_in_the_other_package(tmp_path, lattice, writer, reader):
    ml_j, ml_t = lattice
    ml = {"jax": ml_j, "torch": ml_t}[writer]
    p = str(tmp_path / "hl.npz")
    PKGS[writer].save_hierarchy(ml, p)
    ml_r = PKGS[reader].load_hierarchy(p)
    assert type(ml_r.levels[0].A).__name__ == "LatticeMatrix"
    _same_hierarchy(ml_r, ml)
    _same_hierarchy(ml_r, PKGS[writer].load_hierarchy(p))
    # the factored stash is not written, by either package
    assert all(getattr(L, "T_tent", None) is None for L in ml_r.levels)


def test_loaded_lattice_hierarchy_lowers_nonfactored_in_both(tmp_path, lattice):
    """The loaded hierarchy lowers to non-factored legs (and tail) in both
    packages, and its port V-cycle equals the original's factored one."""
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration

    ml_j, ml_t = lattice
    p = str(tmp_path / "hl.npz")
    amt.save_hierarchy(ml_t, p)
    with jax_env(**PLAIN_TILES):
        h_j = build_j(amg.load_hierarchy(p), dtype=jnp.float32)
    assert all(L.fused is not None and not L.fused.factored for L in h_j.levels)
    with jax_env(**PLAIN_TILES):
        assert build_j(ml_j, dtype=jnp.float32).levels[0].fused.factored

    ml_l = amt.load_hierarchy(p)
    legs = amt.build_device_hierarchy(ml_l, device="cpu", dtype=torch.float64, tail=False)
    assert all(L.fused is not None and not L.fused.factored for L in legs.levels)
    h_l = amt.build_device_hierarchy(ml_l, device="cpu", dtype=torch.float64, tail_max_rows=5000)
    h_o = amt.build_device_hierarchy(ml_t, device="cpu", dtype=torch.float64, tail_max_rows=5000)
    assert h_l.tail_start == h_o.tail_start == 1
    assert not h_l.tail.factored and h_o.tail.factored
    n = ml_t.levels[0].A.shape[0]
    b = torch.zeros(h_o.levels[0].A.rows_padded, dtype=torch.float64)
    b[:n] = torch.as_tensor(np.random.default_rng(3).standard_normal(n))
    y_l = _one_iteration(h_l, amt.V(), torch.zeros_like(b), b)
    y_o = _one_iteration(h_o, amt.V(), torch.zeros_like(b), b)
    assert float((y_l - y_o).abs().max() / y_o.abs().max()) < 1e-12


def test_loaded_hierarchy_refined_solve(tmp_path, lattice):
    """``solve_refined`` on the loaded hierarchy (non-factored legs and
    tail on the CPU, bf16 planes) reaches 1e-8 within 4 rounds, as the
    flagship's anchor asks of the card."""
    _, ml_t = lattice
    p = str(tmp_path / "hl.npz")
    amt.save_hierarchy(ml_t, p)
    ml_l = amt.load_hierarchy(p)
    A = ml_t.levels[0].A
    b = A @ np.ones(A.shape[0])
    x, history = amt.solve_refined(ml_l, b, device="cpu", coef_dtype=torch.bfloat16, log=True)
    assert not amt.get_device_hierarchy(ml_l, "cpu", coef_dtype=torch.bfloat16).tail.factored
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-8
    assert len(history) <= 5  # the initial residual and at most 4 rounds
