"""The port's probing Galerkin product on slab-sharded lattice levels
(``parallel.rap_planes_sharded``) on the 216² hierarchy of
tests/test_sharded_rap.py, float32, on 1, 2 and 4 gloo CPU ranks (spawned
once each for the module): on the sharded L0 (each rank's slab of the
coarse planes, gathered here) the planes match the host child level's
``spec.expand_all()``, and on the last level (replicated on every mesh,
whole on every rank) the dense coarse matrix read as planes, to 5e-6
relative, as the JAX test holds its own; at n_sh = 1 they match the JAX
``rap_planes_sharded`` to 1e-6."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from algebraicmultigrid_tpu_torch.parallel import make_row_mesh, run_ranks

from torch_port_common import RAP_LAST_OFFSETS, rap_rank, slab_problem

RANKS = (2, 4)


@pytest.fixture(scope="module")
def results():
    out = {1: [rap_rank(make_row_mesh(device="cpu"))]}
    for n_sh in RANKS:
        out[n_sh] = run_ranks(rap_rank, n_sh, device="cpu", timeout_s=240)
    return out


@pytest.fixture(scope="module")
def ml_t():
    return slab_problem(amt)


def _planes(res, key):
    """(level, the whole padded planes) from every rank's result."""
    li, _, sharded = res[0][key]
    if not sharded or len(res) == 1:
        for r in res[1:]:  # a replicated level: the same planes on every rank
            assert np.array_equal(r[key][1], res[0][key][1])
        return li, res[0][key][1]
    return li, np.concatenate([r[key][1] for r in res], axis=1)


def _host_planes(ml, li):
    """The child of level ``li`` as planes: its lattice spec expanded, or
    the dense coarse matrix read at ``RAP_LAST_OFFSETS`` on its grid."""
    if li + 1 < len(ml.levels):
        return ml.levels[li + 1].A.spec.expand_all(dtype=np.float64)
    Wx, Wy = ml.levels[li].T_tent.spec.col_dims
    Ac = ml.final_A.toarray()
    out = np.zeros((len(RAP_LAST_OFFSETS), Wx, Wy))
    for j, (du, dv) in enumerate(RAP_LAST_OFFSETS):
        for x in range(Wx):
            for y in range(Wy):
                if 0 <= x + du < Wx and 0 <= y + dv < Wy:
                    out[j, x, y] = Ac[x * Wy + y, (x + du) * Wy + y + dv]
    return out


@pytest.mark.parametrize("n_sh", (1,) + RANKS)
@pytest.mark.parametrize("key", ["sharded", "replicated"])
def test_rap_matches_host_child(results, ml_t, key, n_sh):
    li, planes = _planes(results[n_sh], key)
    assert results[n_sh][0][key][2] == (key == "sharded")
    host = _host_planes(ml_t, li)
    got = planes[:, : host.shape[1], : host.shape[2]].astype(np.float64)
    assert got.shape == host.shape
    assert np.abs(got - host).max() / np.abs(host).max() < 5e-6


def test_one_rank_matches_jax(results):
    from algebraicmultigrid_tpu.parallel.lattice_cycle import AXIS, build_slab_hierarchy
    from algebraicmultigrid_tpu.parallel.sharded_rap import rap_planes_sharded

    ml_j = slab_problem(amg)
    h = build_slab_hierarchy(ml_j, 1)
    mesh = Mesh(np.array(jax.devices()[:1]), (AXIS,))
    for key in ("sharded", "replicated"):
        li, got = _planes(results[1], key)
        offs = ml_j.levels[li + 1].A.spec.offsets if key == "sharded" else RAP_LAST_OFFSETS
        want = np.asarray(rap_planes_sharded(h, li, mesh, offs), dtype=np.float64)
        assert got.shape == want.shape
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-6
