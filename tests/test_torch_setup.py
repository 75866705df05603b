"""The port's host setup tier against the JAX package's: the structured SA
hierarchy must come out exactly equal, and the port must not import JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from torch_port_common import setup_both

REPO = Path(__file__).resolve().parents[1]

# all-lattice hierarchies (the device engine's input) ...
LATTICE_CASES = [(192, 3), (150, 3), (160, 3)]
# ... and grids too small for the proxy path, whose generic SA tail stays CSR
CASES = LATTICE_CASES + [(96, 3), (128, 2)]


def _same_matrix(a, b):
    if sp.issparse(a) or sp.issparse(b):
        assert sp.issparse(a) and sp.issparse(b)
        assert a.shape == b.shape and (sp.csr_matrix(a) != sp.csr_matrix(b)).nnz == 0
    else:
        _spec_equal(a.spec, b.spec)


def _spec_equal(a, b):
    assert tuple(map(tuple, a.offsets)) == tuple(map(tuple, b.offsets))
    assert tuple(a.row_dims) == tuple(b.row_dims)
    assert tuple(a.col_dims) == tuple(b.col_dims)
    assert (a.Kx, a.sx, a.Ky, a.sy) == (b.Kx, b.sx, b.Ky, b.sy)
    assert tuple(a.base_x) == tuple(b.base_x) and tuple(a.base_y) == tuple(b.base_y)
    assert a.table.dtype == b.table.dtype
    assert np.array_equal(a.table, b.table)


@pytest.mark.parametrize("n,box", CASES)
def test_hierarchy_matches_jax_exactly(n, box):
    ml_j, ml_t = setup_both(n, box)
    assert len(ml_t.levels) == len(ml_j.levels)
    assert ml_t.operator_complexity() == ml_j.operator_complexity()
    for Lj, Lt in zip(ml_j.levels, ml_t.levels):
        for name in ("A", "P", "R", "T_tent"):
            _same_matrix(getattr(Lj, name), getattr(Lt, name))
        sj, st = Lj.psmooth_scale, Lt.psmooth_scale
        if isinstance(sj, tuple):
            assert isinstance(st, tuple) and sj[0] == st[0] == "table"
            assert np.array_equal(sj[1], st[1]) and tuple(sj[2]) == tuple(st[2])
        else:
            assert np.array_equal(np.asarray(sj), np.asarray(st))
        assert repr(Lj.presmoother_config) == repr(Lt.presmoother_config)
        assert repr(Lj.postsmoother_config) == repr(Lt.postsmoother_config)
    assert (sp.csr_matrix(ml_j.final_A) != sp.csr_matrix(ml_t.final_A)).nnz == 0
    cj, ct = ml_j.coarse_solver, ml_t.coarse_solver
    assert type(cj).__name__ == type(ct).__name__ == "QRSolver"
    assert np.array_equal(cj.Q, ct.Q) and np.array_equal(cj.R, ct.R)


@pytest.mark.parametrize("n,box", LATTICE_CASES)
def test_every_level_is_a_lattice_matrix(n, box):
    from algebraicmultigrid_tpu_torch.models.lattice import LatticeMatrix

    _, ml_t = setup_both(n, box)
    for L in ml_t.levels:
        assert all(isinstance(M, LatticeMatrix) for M in (L.A, L.P, L.R))


def test_port_import_leaves_jax_unloaded():
    code = (
        "import sys, algebraicmultigrid_tpu_torch as amt\n"
        "ml = amt.structured_smoothed_aggregation(amt.poisson((48, 48), lattice=True),"
        " aggregate=amt.StructuredAggregation(box=3))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'algebraicmultigrid_tpu.'))"
        " or m == 'algebraicmultigrid_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
