"""The port's 3-D lattice tier against the JAX package's, on the 45³ problem
of ``tests/test_lattice_nd.py`` (``proxy=12, cut_rows=2000``): the
structured SA hierarchy exactly equal, the LatND SpMV in float64 to 1e-12,
one V-cycle in float64 to 1e-10 (carried across with
``convert.hierarchy_from_numpy`` and built by the port, whose L0 runs K7's
plain version), equal PCG iteration counts in float32, and the refined
solve to 1e-8."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from torch_port_common import jax_basis_to_numpy, jax_hierarchy_to_numpy, rel_err

DIMS = (45, 45, 45)
SETUP_KW = dict(proxy=12, cut_rows=2000, min_proxy_dim=9, box=3)
N = int(np.prod(DIMS))


@pytest.fixture(scope="module")
def pair():
    ml_j = amg.structured_smoothed_aggregation_nd(amg.poisson(DIMS, lattice=True), **SETUP_KW)
    ml_t = amt.structured_smoothed_aggregation_nd(amt.poisson(DIMS, lattice=True), **SETUP_KW)
    return ml_j, ml_t


@pytest.fixture(scope="module")
def hierarchies(pair):
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy as build_t

    ml_j, ml_t = pair
    h_j = build_j(ml_j, dtype=jnp.float64)
    return h_j, build_t(ml_t, device="cpu", dtype=torch.float64)


def _spec_equal(a, b):
    assert tuple(map(tuple, a.offsets)) == tuple(map(tuple, b.offsets))
    for f in ("row_dims", "col_dims", "Ks", "ss"):
        assert tuple(getattr(a, f)) == tuple(getattr(b, f)), f
    assert tuple(map(tuple, a.bases)) == tuple(map(tuple, b.bases))
    assert a.table.dtype == b.table.dtype and np.array_equal(a.table, b.table)


def _same_matrix(a, b):
    if sp.issparse(a) or sp.issparse(b):
        assert sp.issparse(a) and sp.issparse(b)
        assert a.shape == b.shape and (sp.csr_matrix(a) != sp.csr_matrix(b)).nnz == 0
    else:
        assert type(a).__name__ == type(b).__name__
        _spec_equal(a.spec, b.spec)


def test_gallery_lattice_problem_nd():
    got = amt.poisson((7, 6, 5), lattice=True)
    want = amg.poisson((7, 6, 5), lattice=True)
    assert isinstance(got, amt.LatticeProblemND)
    _spec_equal(got.spec, want.spec)
    assert (got.tocsr() != want.tocsr()).nnz == 0


def test_hierarchy_matches_jax_exactly(pair):
    ml_j, ml_t = pair
    assert len(ml_t.levels) == len(ml_j.levels) == 3
    assert isinstance(ml_t.levels[0].A, amt.LatticeMatrixND)
    assert ml_t.operator_complexity() == ml_j.operator_complexity()
    for Lj, Lt in zip(ml_j.levels, ml_t.levels):
        for name in ("A", "P", "R"):
            _same_matrix(getattr(Lj, name), getattr(Lt, name))
        assert repr(Lj.presmoother_config) == repr(Lt.presmoother_config)
        assert repr(Lj.postsmoother_config) == repr(Lt.postsmoother_config)
    assert (sp.csr_matrix(ml_j.final_A) != sp.csr_matrix(ml_t.final_A)).nnz == 0
    cj, ct = ml_j.coarse_solver, ml_t.coarse_solver
    assert type(cj).__name__ == type(ct).__name__ == "QRSolver"
    assert np.array_equal(cj.Q, ct.Q) and np.array_equal(cj.R, ct.R)


@pytest.mark.parametrize("op", ["A", "P", "R"])
def test_latnd_spmv_matches_jax(pair, op):
    from algebraicmultigrid_tpu.ops.lattice_nd_op import latnd_from_spec as from_j, latnd_spmv as spmv_j
    from algebraicmultigrid_tpu_torch.ops.banded import mat_vec
    from algebraicmultigrid_tpu_torch.ops.lattice_nd_op import latnd_from_spec as from_t

    ml_j, ml_t = pair
    Mj = from_j(getattr(ml_j.levels[0], op).spec, dtype=jnp.float64)
    Mt = from_t(getattr(ml_t.levels[0], op).spec, torch.float64, "cpu")
    assert Mt.rows_padded == Mj.rows_padded and Mt.shape == Mj.shape and Mt.nnz == Mj.nnz
    assert np.array_equal(Mt.data.numpy(), np.asarray(Mj.data))
    x = np.random.default_rng(0).standard_normal(Mt.shape[1] + 3)
    want = np.asarray(spmv_j(Mj, jnp.asarray(x)))
    got = mat_vec(Mt, torch.as_tensor(x)).numpy()
    assert got.shape == want.shape and rel_err(got, want) < 1e-12


def test_lowering_matches_jax(hierarchies):
    from algebraicmultigrid_tpu_torch.ops.kernels.sweep3d import Sweep3DCache

    h_j, h_t = hierarchies
    for Lj, Lt in zip(h_j.levels, h_t.levels):
        for op in ("A", "P", "R"):
            assert type(getattr(Lt, op)).__name__ == type(getattr(Lj, op)).__name__
            assert getattr(Lt, op).rows_padded == getattr(Lj, op).rows_padded
    L0 = h_t.levels[0]
    assert type(L0.A).__name__ == "LatND" and len(L0.A.offsets) == 7
    for c in (L0.pre, L0.post):
        assert isinstance(c, Sweep3DCache) and c.n_colors == 2 and c.steps == (0, 1, 0) and c.halo == (3, 3, 3)
        assert c.A is L0.A
    assert all(type(L.pre).__name__ == "MaskedMulticolorCache" for L in h_t.levels[1:])


def _sweep_dicts(levels, ml):
    """The converted levels with each 3-D lattice level's smoothers as K7
    dicts (the masked caches' dinv and the level's periodic table)."""
    from algebraicmultigrid_tpu_torch.models.lattice_nd import lattice_coloring_nd

    out = []
    for L, Lh in zip(levels, ml.levels):
        if L["A"].get("format") == "LatND":
            tab, nc = lattice_coloring_nd(Lh.A.spec)
            L = dict(L, **{
                k: dict(kind="Sweep3DCache", dinv=L[k]["dinv"], color_table=tab, n_colors=nc,
                        omega=L[k]["omega"], iter=L[k]["iter"], forward=L[k]["forward"], backward=L[k]["backward"])
                for k in ("pre", "post")
            })
        out.append(L)
    return out


@pytest.mark.parametrize("cyc", ["V", "W"])
def test_cycle_matches_jax(pair, hierarchies, cyc):
    from algebraicmultigrid_tpu.models.device import _one_iteration as cycle_j
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration as cycle_t
    from algebraicmultigrid_tpu_torch.ops.kernels.sweep3d import Sweep3DCache

    _, ml_t = pair
    h_j, h_t = hierarchies
    levels, coarse = jax_hierarchy_to_numpy(h_j)
    basis = jax_basis_to_numpy(h_j)
    ports = {
        "converted": hierarchy_from_numpy(levels, coarse, device="cpu", dtype=torch.float64, **basis),
        "converted_k7": hierarchy_from_numpy(
            _sweep_dicts(levels, ml_t), coarse, device="cpu", dtype=torch.float64, **basis
        ),
        "built": h_t,
    }
    assert isinstance(ports["converted_k7"].levels[0].pre, Sweep3DCache)
    b = np.zeros(h_j.fine_padded)
    b[:N] = np.random.default_rng(1).standard_normal(N)
    want = np.asarray(cycle_j(h_j, getattr(amg, cyc)(), jnp.zeros(b.shape[0]), jnp.asarray(b)))
    for name, h in ports.items():
        got = cycle_t(h, getattr(amt, cyc)(), torch.zeros(b.shape[0], dtype=torch.float64), torch.as_tensor(b))
        assert rel_err(got.numpy(), want) < 1e-10, name


def test_cg_device_iteration_counts_match(pair):
    from algebraicmultigrid_tpu.models.device import cg_device as cg_j

    ml_j, ml_t = pair
    b = np.random.default_rng(2).standard_normal(N)
    _, it_j, nr_j = cg_j(ml_j, b, dtype="float32", log=True)
    x_t, it_t, nr_t = amt.cg_device(ml_t, b, device="cpu", dtype=torch.float32, log=True)
    assert it_t == it_j
    assert nr_t <= 1e-8 * np.linalg.norm(b)


def test_solve_refined_reaches_tolerance(pair):
    _, ml_t = pair
    prob = ml_t.levels[0].A
    b = np.random.default_rng(3).standard_normal(N)
    x, hist = amt.solve_refined(ml_t, b, tol=1e-8, device="cpu", log=True)
    assert len(hist) - 1 <= 4
    assert np.linalg.norm(b - prob @ x) / np.linalg.norm(b) < 1e-8


def test_zero_diagonal_level_keeps_masked_sweep():
    """K7 needs every cell of a 3-D level active; a zero diagonal keeps the
    masked sweep, which freezes that row."""
    from algebraicmultigrid_tpu_torch.models.device import MaskedMulticolorCache, _build_smoother_cache
    from algebraicmultigrid_tpu_torch.ops.kernels.sweep3d import Sweep3DCache
    from algebraicmultigrid_tpu_torch.ops.lattice_nd_op import latnd_from_spec

    cfg = amt.GaussSeidel(ordering="multicolor")
    prob = amt.poisson((12, 10, 9), lattice=True)
    A_dev = latnd_from_spec(prob.spec, torch.float64, "cpu")
    assert isinstance(_build_smoother_cache(cfg, prob, A_dev, torch.float64, "cpu"), Sweep3DCache)
    spec = prob.spec
    k0 = [tuple(d) for d in spec.offsets].index((0, 0, 0))
    table = spec.table.copy()
    table[(k0,) + (0,) * 3] = 0.0  # the corner class's diagonal
    zero = amt.LatticeMatrixND(type(spec)(**{**spec.__dict__, "table": table}))
    A_zero = latnd_from_spec(zero.spec, torch.float64, "cpu")
    cache = _build_smoother_cache(cfg, zero, A_zero, torch.float64, "cpu")
    assert isinstance(cache, MaskedMulticolorCache)
    assert int(cache.color_of[0]) == cache.n_colors  # the frozen row
