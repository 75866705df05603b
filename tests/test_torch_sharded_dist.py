"""The port's generic sharded tier (``parallel.shard_hierarchy``,
``build_sharded_hierarchy``, ``solve_sharded``) on 1, 2 and 4 gloo CPU
ranks (the 2- and 4-rank groups spawned once each for the module), on the
problems of tests/test_multichip.py:

* each level's A, P, R and smoother arrays held as a row block exactly
  where the JAX ``shard_hierarchy`` shards them on ``make_row_mesh(n)`` of
  the 8-device CPU mesh (n = 2, 4), and each rank's block bitwise equal to
  the JAX shard's data; the single-card caches (legs, tail, subcycle) gone;
* RS 48² (multicolor GS, V, ``replicate_below=1024``, float64, reltol
  1e-8): the JAX ``ml.solve(engine="jax")``'s iteration count, x within
  1e-10; SA 32² with Jacobi and a W cycle: ‖x − 1‖∞ < 1e-5; the 144²
  structured-SA lattice (float64, reltol 1e-6, ``replicate_below=256``):
  ‖x − 1‖∞ < 1e-4; a [n, 3] block: the iterations of the port's
  single-device ``solve_device`` on the same block, x within 1e-12;
* one sharded V-cycle against the single-device port cycle of the same
  unfused hierarchy, 1e-14 relative (float64);
* RS 32² with natural-order GS (``replicate_below=512``): its ELL level in
  row blocks, swept whole after a gather, x that of ``solve_device``;
* every rank returns the same (x, iterations, ‖r‖).

K7's cache on a 3-D level is not exercised: the JAX package makes it only
for grids whose last axis is a multiple of 128 (``AMG_SWEEP3D=1``), which
no small 3-D lattice setup here reaches."""

import numpy as np
import pytest
import torch

import jax

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from algebraicmultigrid_tpu_torch.parallel import make_row_mesh, run_ranks

from torch_port_common import DIST_PROBLEMS, dist_problem, dist_rank, rel_err

RANKS = (2, 4)


@pytest.fixture(scope="module")
def results():
    out = {1: [dist_rank(make_row_mesh(device="cpu"))]}
    for n_sh in RANKS:
        out[n_sh] = run_ranks(dist_rank, n_sh, device="cpu", timeout_s=240)
    return out


@pytest.fixture(scope="module")
def problems():
    return {name: (dist_problem(amg, name), dist_problem(amt, name)) for name in DIST_PROBLEMS}


def _jax_arrays(E):
    """The main array of a JAX device operator (None where it has none)."""
    return getattr(E, "data", getattr(E, "mat", None))


def _jax_sharded(a) -> bool:
    return not a.sharding.is_fully_replicated


def _shard(a, r):
    """Device r's shard of a JAX array."""
    dev = jax.devices()[r]
    return np.asarray(next(s.data for s in a.addressable_shards if s.device == dev))


@pytest.mark.parametrize("n_sh", RANKS)
@pytest.mark.parametrize("name", list(DIST_PROBLEMS))
def test_layout_matches_jax_shard_hierarchy(results, problems, name, n_sh):
    from algebraicmultigrid_tpu.parallel import build_sharded_hierarchy, make_row_mesh as mesh_j

    below, dtype = DIST_PROBLEMS[name]
    (ml_j, _), _ = problems[name]
    h_j = build_sharded_hierarchy(ml_j, mesh_j(n_sh), dtype=dtype, replicate_below=below)
    for rank, res in enumerate(results[n_sh]):
        layout = res[name, "layout"]
        assert len(layout) == len(h_j.levels)
        assert res[name, "caches"] == (None, None)
        for L_t, L_j in zip(layout, h_j.levels):
            assert L_t["fused"] is None
            for op in ("A", "P", "R"):
                blocked, arr = L_t[op]
                a_j = _jax_arrays(getattr(L_j, op))
                assert blocked == _jax_sharded(a_j), (op, type(getattr(L_j, op)).__name__)
                want = _shard(a_j, rank) if blocked else np.asarray(a_j)
                assert arr.dtype == want.dtype and np.array_equal(arr, want), op
            for which in ("pre", "post"):
                blocked, kind, arrs = L_t[which]
                c_j = getattr(L_j, which)
                assert kind == type(c_j).__name__
                for f, arr in arrs.items():
                    a_j = getattr(c_j, f)
                    assert blocked == _jax_sharded(a_j), (which, f)
                    want = _shard(a_j, rank) if blocked else np.asarray(a_j)
                    assert np.array_equal(arr, want), (which, f)
    # the fine levels are held in blocks, the coarse ones whole
    first = results[n_sh][0][name, "layout"]
    assert first[0]["A"][0] and not first[-1]["A"][0]


def _same_on_every_rank(res, key):
    x0, it0, nr0 = res[0][key]
    for r in res[1:]:
        x, it, nr = r[key]
        assert it == it0 and nr == nr0 and np.array_equal(x, x0)
    return x0, it0, nr0


@pytest.mark.parametrize("n_sh", (1,) + RANKS)
def test_rs_solve_matches_jax_engine(results, problems, n_sh):
    (ml_j, b), _ = problems["rs48"]
    x, iters, normres = _same_on_every_rank(results[n_sh], ("rs48", "solve"))
    assert normres <= 1e-8 * np.linalg.norm(b)
    x_1, res_1 = ml_j.solve(b, amg.V(), engine="jax", reltol=1e-8, log=True)
    assert iters == len(res_1) - 1
    assert np.allclose(x, x_1, atol=1e-10)


@pytest.mark.parametrize("n_sh", (1,) + RANKS)
def test_sa_w_cycle_and_lattice_solve(results, problems, n_sh):
    (_, b_sa), _ = problems["sa32"]
    x, _, nr = _same_on_every_rank(results[n_sh], ("sa32", "solve"))
    assert nr <= 1e-8 * np.linalg.norm(b_sa) and np.abs(x - 1).max() < 1e-5
    (_, b_lat), _ = problems["lat144"]
    x, _, nr = _same_on_every_rank(results[n_sh], ("lat144", "solve"))
    assert nr <= 1e-6 * np.linalg.norm(b_lat) and np.abs(x - 1).max() < 1e-4


@pytest.mark.parametrize("n_sh", (1,) + RANKS)
def test_natural_order_gs_level_matches_solve_device(results, problems, n_sh):
    """RS 32² with natural-order GS and ``replicate_below=512``: its L0
    (1024 rows, ELL) held in row blocks, the sweep run on the gathered
    level, the answer the single-device one."""
    _, (ml_t, b) = problems["gs32"]
    x, iters, _ = _same_on_every_rank(results[n_sh], ("gs32", "solve"))
    layout = results[n_sh][0]["gs32", "layout"]
    assert layout[0]["pre"][1] == "ScanGSCache" and layout[0]["pre"][0] == (n_sh > 1)
    x_1, res_1 = amt.solve_device(ml_t, b, amt.V(), reltol=1e-8, device="cpu", dtype=torch.float64, log=True)
    assert iters == len(res_1) - 1
    assert np.abs(x - x_1).max() < 1e-12


@pytest.mark.parametrize("n_sh", (1,) + RANKS)
def test_multi_rhs_block_matches_solve_device(results, problems, n_sh):
    _, (ml_t, b) = problems["rs48"]
    x, iters, _ = _same_on_every_rank(results[n_sh], ("rs48", "block"))
    B = np.random.default_rng(5).standard_normal((b.shape[0], 3))
    x_1, res_1 = amt.solve_device(ml_t, B, amt.V(), reltol=1e-8, device="cpu", dtype=torch.float64, log=True)
    assert x.shape == B.shape and iters == len(res_1) - 1
    assert np.abs(x - x_1).max() < 1e-12


@pytest.mark.parametrize("n_sh", RANKS)
def test_sharded_vcycle_matches_single_device(results, problems, n_sh):
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy

    _, (ml_t, b) = problems["lat144"]
    h = build_device_hierarchy(ml_t, device="cpu", dtype=torch.float64, fused=False, tail=False, sweeps=False,
                               row_pad=8 * n_sh)
    bp = torch.zeros(h.fine_padded, dtype=torch.float64)
    bp[: b.shape[0]] = torch.as_tensor(np.random.default_rng(6).standard_normal(b.shape[0]))
    want = _one_iteration(h, amt.V(), torch.zeros_like(bp), bp).numpy()
    for res in results[n_sh]:
        assert rel_err(res["lat144", "vcycle"], want) < 1e-14


def test_one_rank_blocks_nothing(results):
    """At n_sh = 1 every level is whole (the single-device hierarchy without
    its single-card caches)."""
    for name in DIST_PROBLEMS:
        for L in results[1][0][name, "layout"]:
            assert not any(L[op][0] for op in ("A", "P", "R", "pre", "post"))
