"""Structured Ruge–Stüben (``ruge_stuben(A, CF=StructuredRS())`` on a
lattice problem, ``structured_ruge_stuben``) in the port against the JAX
package: the hierarchy exactly equal at two sizes with small proxies (its
semi-coarsened Lat2D levels, CSR levels between them, the coarse QR), the
64² float64 device solve of ``tests/test_lattice_fastpath.py`` to 1e-6, one
float64 V-cycle against the JAX device cycle to 1e-10 (on 192² cut to six
levels, whose Lat2D levels all run K5's plain version), the refined solve's
rounds and PCG iterations equal to the JAX package's, bf16 planes leaving this hierarchy
bitwise as it was (it has no legs, tail or LatND level), and the new
exports of the same kind as the JAX package's."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from torch_port_common import rel_err

# (n, proxy, cut_rows, min_proxy_dim): both keep Lat2D levels on the
# structured path (L0–L4 and L6 at 192², L0–L4 and L6 at 128²)
CASES = [(192, 64, 2000, 16), (128, 48, 1000, 12)]
# the device tests' hierarchy: 192² cut to 6 levels (L0–L4 Lat2D, of 5, 11,
# 21, 29 and 37 offsets, and a 1152-row QR), which keeps the JAX package's
# compiles of its cycle and PCG within seconds
N, KW = 192, dict(proxy=64, cut_rows=2000, min_proxy_dim=16, max_levels=6)


def rs_setup(pkg, n, **kw):
    """poisson((n, n)) through ``ruge_stuben`` with ``StructuredRS`` and
    multicolor GS, as ``bench.py``'s ``AMG_BENCH_METHOD=rs`` sets it up."""
    gs = pkg.GaussSeidel(ordering="multicolor")
    CF = pkg.StructuredRS() if pkg is amt else pkg.models.structured.StructuredRS()
    return pkg.ruge_stuben(pkg.poisson((n, n), lattice=True), CF=CF, presmoother=gs, postsmoother=gs, **kw)


@pytest.fixture(scope="module")
def pair():
    return rs_setup(amg, N, **KW), rs_setup(amt, N, **KW)


def _same_matrix(a, b):
    if sp.issparse(a) or sp.issparse(b):
        assert sp.issparse(a) and sp.issparse(b)
        assert a.shape == b.shape and (sp.csr_matrix(a) != sp.csr_matrix(b)).nnz == 0
        return
    assert type(a).__name__ == type(b).__name__
    sa, sb = a.spec, b.spec
    assert tuple(map(tuple, sa.offsets)) == tuple(map(tuple, sb.offsets))
    for f in ("row_dims", "col_dims", "base_x", "base_y"):
        assert tuple(getattr(sa, f)) == tuple(getattr(sb, f)), f
    assert (sa.Kx, sa.sx, sa.Ky, sa.sy) == (sb.Kx, sb.sx, sb.Ky, sb.sy)
    assert sa.table.dtype == sb.table.dtype and np.array_equal(sa.table, sb.table)


@pytest.mark.parametrize("n,proxy,cut_rows,min_proxy_dim", CASES)
def test_hierarchy_matches_jax_exactly(n, proxy, cut_rows, min_proxy_dim):
    from algebraicmultigrid_tpu_torch.models.lattice import LatticeMatrix

    kw = dict(proxy=proxy, cut_rows=cut_rows, min_proxy_dim=min_proxy_dim)
    ml_j, ml_t = rs_setup(amg, n, **kw), rs_setup(amt, n, **kw)
    assert len(ml_t.levels) == len(ml_j.levels) == 9
    assert ml_t.operator_complexity() == ml_j.operator_complexity()
    lattice = [i for i, L in enumerate(ml_t.levels) if isinstance(L.A, LatticeMatrix)]
    assert lattice == [0, 1, 2, 3, 4, 6]
    # semi-coarsening: the transfer bases alternate between the axes
    bases = {(tuple(ml_t.levels[i].P.spec.base_x), tuple(ml_t.levels[i].P.spec.base_y)) for i in lattice}
    assert bases == {((1, 1), (1, 2)), ((1, 2), (1, 1))}
    for Lj, Lt in zip(ml_j.levels, ml_t.levels):
        for name in ("A", "P", "R"):
            _same_matrix(getattr(Lj, name), getattr(Lt, name))
        assert repr(Lj.presmoother_config) == repr(Lt.presmoother_config)
        assert repr(Lj.postsmoother_config) == repr(Lt.postsmoother_config)
    assert (sp.csr_matrix(ml_j.final_A) != sp.csr_matrix(ml_t.final_A)).nnz == 0
    cj, ct = ml_j.coarse_solver, ml_t.coarse_solver
    assert type(cj).__name__ == type(ct).__name__ == "QRSolver"
    assert np.array_equal(cj.Q, ct.Q) and np.array_equal(cj.R, ct.R)


def test_fast_setup_device_solve_small():
    """tests/test_lattice_fastpath.py's 64² case through the port's device
    engine in float64."""
    n = 64
    LP = amt.poisson((n, n), lattice=True)
    ml = amt.structured_ruge_stuben(LP, proxy=32, cut_rows=500, min_proxy_dim=8)
    b = LP @ np.ones(n * n)
    x = ml.solve(b, engine="torch", device="cpu", reltol=1e-8, dtype="float64")
    assert np.abs(x - 1).max() < 1e-6


def test_vcycle_matches_jax(pair):
    """One float64 V-cycle of the port's hierarchy (K5 on every level, the
    37-offset L4 through K5's wide instance; no legs, no tail) against the
    JAX device cycle."""
    from algebraicmultigrid_tpu.models.device import _one_iteration as cycle_j
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration as cycle_t
    from algebraicmultigrid_tpu_torch.ops.kernels.gs_sweep import GSSweepCache
    from algebraicmultigrid_tpu_torch.ops.lattice_op import Lat2D

    ml_j, ml_t = pair
    h_j = build_j(ml_j, dtype=jnp.float64)
    h_t = amt.build_device_hierarchy(ml_t, device="cpu", dtype=torch.float64)
    assert h_t.tail is None and all(L.fused is None for L in h_t.levels)
    lat = [i for i, L in enumerate(h_t.levels) if isinstance(L.A, Lat2D)]
    assert lat == [0, 1, 2, 3, 4] and len(h_t.levels[4].A.offsets) == 37
    for L in h_t.levels:
        assert isinstance(L.pre, GSSweepCache) and isinstance(L.post, GSSweepCache) and L.pre.march is not None
    assert [type(L.A).__name__ for L in h_t.levels] == [type(L.A).__name__ for L in h_j.levels]
    b = np.zeros(h_j.fine_padded)
    b[: N * N] = np.random.default_rng(7).standard_normal(N * N)
    want = np.asarray(cycle_j(h_j, amg.V(), jnp.zeros(b.shape[0]), jnp.asarray(b)))
    got = cycle_t(h_t, amt.V(), torch.zeros(b.shape[0], dtype=torch.float64), torch.as_tensor(b)).numpy()
    assert rel_err(got, want) < 1e-10


def test_solve_refined_matches_jax_rounds_and_iterations(pair):
    """The refined solve to 1e-8 against the JAX package's refinement (its
    ``solve_refined`` loop: f64 residual, float32 ``_pcg_fused`` to 1e-5,
    at most 40 iterations, f64 update) run here: the same rounds, and the
    same PCG iterations in each."""
    from algebraicmultigrid_tpu.models.device import _pcg_fused
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j

    ml_j, ml_t = pair
    b = np.random.default_rng(8).standard_normal(N * N)
    stats = {}
    x, hist = amt.solve_refined(ml_t, b, tol=1e-8, device="cpu", log=True, stats=stats)
    A = ml_t.levels[0].A
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-8
    assert len(stats["inner_iters"]) == len(hist) - 1 <= 4
    h_j = build_j(ml_j, dtype=jnp.float32)
    x64, iters = np.zeros(N * N), []
    while np.linalg.norm(b - A @ x64) / np.linalg.norm(b) >= 1e-8 and len(iters) < 4:
        r = b - A @ x64
        scale = np.linalg.norm(r)
        bp = np.zeros(h_j.fine_padded, np.float32)
        bp[: N * N] = r / scale
        e, it, _ = _pcg_fused(h_j, jnp.asarray(bp), 40, 1e-5, amg.V())
        iters.append(int(it))
        x64 += scale * np.asarray(e, np.float64)[: N * N]
    assert stats["inner_iters"] == iters


def test_bf16_planes_leave_the_hierarchy_as_it_was(pair):
    """The rs hierarchy has no legs, no tail and no LatND level, so
    ``coef_dtype=torch.bfloat16`` changes nothing: every tensor and one
    V-cycle bitwise equal to the hierarchy built without it, and no raise."""
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration

    _, ml_t = pair
    for dtype in (torch.float32, torch.float64):
        h0 = amt.build_device_hierarchy(ml_t, device="cpu", dtype=dtype)
        h1 = amt.build_device_hierarchy(ml_t, device="cpu", dtype=dtype, coef_dtype=torch.bfloat16)
        assert h1.tail is None and all(L.fused is None for L in h1.levels)
        for L0, L1 in zip(h0.levels, h1.levels):
            for op in ("A", "P", "R"):
                a, b = getattr(L0, op), getattr(L1, op)
                assert type(a) is type(b) and a.dtype == b.dtype == dtype
                assert all(torch.equal(getattr(a, f.name), getattr(b, f.name))
                           for f in dataclasses.fields(a) if isinstance(getattr(a, f.name), torch.Tensor))
        b = torch.zeros(h0.fine_padded, dtype=dtype)
        b[: N * N] = torch.as_tensor(np.random.default_rng(9).standard_normal(N * N), dtype=dtype)
        x0 = _one_iteration(h0, amt.V(), torch.zeros_like(b), b)
        x1 = _one_iteration(h1, amt.V(), torch.zeros_like(b), b)
        assert torch.equal(x0, x1)


def test_exports_are_the_jax_kinds():
    from algebraicmultigrid_tpu.models.fastsetup import structured_ruge_stuben as srs_j
    from algebraicmultigrid_tpu.models.structured import StructuredRS as SRS_j

    assert {"StructuredRS", "structured_ruge_stuben"} <= set(amt.__all__)
    assert isinstance(amt.StructuredRS, type) and isinstance(SRS_j, type)
    assert amt.StructuredRS.__name__ == SRS_j.__name__
    assert callable(amt.structured_ruge_stuben) and callable(srs_j)
    assert amt.structured_ruge_stuben.__name__ == srs_j.__name__
    assert type(amt.StructuredRS()).__name__ == type(SRS_j()).__name__
