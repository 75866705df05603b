"""The port's slab-sharded lattice tier (``parallel/lattice_cycle.py``) on
the 216² hierarchy of ``tests/test_sharded_lattice.py``: the host builder
gives the JAX package's arrays exactly for n_sh = 1, 2, 4, and
``convert.slab_hierarchy_from_numpy`` carries them across; the n_sh = 1
cycle and matvec equal the JAX package's n_sh = 1 program (1e-10 in
float64); on 2 and 4 gloo ranks (spawned once each for the module) the
V/W/F cycles equal the port's n_sh = 1 (2e-5 in float32, the JAX test's
shard-invariance bound, and 1e-12 in float64) and the single-device
masked-sweep cycle (2e-4 in float32, as the JAX test holds it), as does the
Jacobi / backward-SOR hierarchy; ``solve_lattice_sharded`` reaches 1e-6 in
the same number of iterations on every n_sh.  The reference for several
shards is never the JAX multi-device ``shard_map``, which does not finish
here in minutes."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from algebraicmultigrid_tpu_torch.parallel import build_slab_hierarchy, make_row_mesh, run_ranks

from torch_port_common import SLAB_CYCLES, SLAB_DTYPES, SLAB_N, failing_rank, rel_err, slab_problem, slab_rank, slab_rhs

RANKS = (2, 4)
SHARD_TOL = {"float32": 2e-5, "float64": 1e-12}


@pytest.fixture(scope="module")
def problems():
    return slab_problem(amg), slab_problem(amt)


@pytest.fixture(scope="module")
def results():
    """Each rank's slabs: n_sh = 1 in this process, 2 and 4 on gloo ranks."""
    out = {1: [slab_rank(make_row_mesh(device="cpu"))]}
    for n_sh in RANKS:
        out[n_sh] = run_ranks(slab_rank, n_sh, device="cpu", timeout_s=240)
    return out


def _grid(res, key):
    return np.concatenate([r[key] for r in res], axis=0)[:SLAB_N, :SLAB_N]


def _jax_levels(h):
    return [
        {f.name: (np.asarray(v) if hasattr(v, "shape") else v) for f in dataclasses.fields(lv)
         for v in [getattr(lv, f.name)]}
        for lv in h.levels
    ]


@pytest.mark.parametrize("n_sh", [1, 2, 4])
def test_build_slab_hierarchy_matches_jax(problems, n_sh):
    from algebraicmultigrid_tpu.parallel.lattice_cycle import build_slab_hierarchy as build_j

    ml_j, ml_t = problems
    hj = build_j(ml_j, n_sh)
    ht = build_slab_hierarchy(ml_t, n_sh)
    assert len(hj.levels) == len(ht.levels)
    assert ht.levels[0].sharded and not ht.levels[-1].sharded
    for lj, lt in zip(_jax_levels(hj), ht.levels):
        for f in ("A", "dinv", "T", "S"):
            assert lj[f].dtype == getattr(lt, f).dtype and np.array_equal(lj[f], getattr(lt, f)), f
        for f in ("offsets", "color_tab", "pre_sm", "post_sm", "k", "dims", "pdims", "Hp", "sharded"):
            assert lj[f] == getattr(lt, f), f
    assert np.array_equal(np.asarray(hj.pinv), ht.pinv)
    assert (hj.ctrue, hj.cpad, hj.n_sh) == (ht.ctrue, ht.cpad, ht.n_sh)


def test_slab_hierarchy_from_numpy_round_trip(problems):
    """The JAX hierarchy's arrays, carried across for each rank, equal the
    port's own hierarchy placed on that rank."""
    from algebraicmultigrid_tpu.parallel.lattice_cycle import build_slab_hierarchy as build_j
    from algebraicmultigrid_tpu_torch.convert import slab_hierarchy_from_numpy

    ml_j, ml_t = problems
    hj = build_j(ml_j, 2, dtype="float64")
    ht = build_slab_hierarchy(ml_t, 2, dtype="float64")
    for rank in range(2):
        got = slab_hierarchy_from_numpy(_jax_levels(hj), np.asarray(hj.pinv), hj.ctrue, hj.cpad, 2,
                                        rank=rank, device="cpu")
        want = ht.to_rank(rank, "cpu")
        assert got.rank == want.rank == rank
        for a, b in zip(got.levels, want.levels):
            assert a.A.shape[0] == len(a.offsets) and a.A.shape[1:] == a.dinv.shape
            for f in ("A", "dinv", "T", "S"):
                assert torch.equal(getattr(a, f), getattr(b, f)), f
            assert dataclasses.replace(a, A=0, dinv=0, T=0, S=0) == dataclasses.replace(b, A=0, dinv=0, T=0, S=0)
        assert torch.equal(got.pinv, want.pinv)


def test_one_slab_matches_jax_program(problems, results):
    """n_sh = 1: the JAX package runs its program without shard_map (the
    8.5 s reference); cycle and matvec in float64."""
    from algebraicmultigrid_tpu.parallel.lattice_cycle import (
        AXIS,
        build_slab_hierarchy as build_j,
        cycle_lattice_sharded as cycle_j,
        matvec_lattice_sharded as matvec_j,
    )

    ml_j, _ = problems
    hj = build_j(ml_j, 1, dtype="float64")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), (AXIS,))
    b = jnp.asarray(slab_rhs(hj.fine_pdims, 1))
    want_x = np.asarray(cycle_j(hj, jnp.zeros_like(b), b, mesh))[:SLAB_N, :SLAB_N]
    want_y = np.asarray(matvec_j(hj, b, mesh))[:SLAB_N, :SLAB_N]
    assert rel_err(_grid(results[1], ("float64", "v")), want_x) < 1e-10
    assert rel_err(_grid(results[1], ("float64", "matvec")), want_y) < 1e-10


@pytest.mark.parametrize("dtype", SLAB_DTYPES)
@pytest.mark.parametrize("cyc", SLAB_CYCLES + ("matvec",))
@pytest.mark.parametrize("n_sh", RANKS)
def test_sharded_matches_one_slab(results, n_sh, cyc, dtype):
    got = _grid(results[n_sh], (dtype, cyc))
    want = _grid(results[1], (dtype, cyc))
    assert np.isfinite(got).all()
    assert rel_err(got, want) < SHARD_TOL[dtype]


@pytest.mark.parametrize("cyc", SLAB_CYCLES)
def test_sharded_cycle_matches_single_device(problems, results, cyc):
    """The 4-slab cycle against the port's single-device masked-sweep
    ``_cycle`` (same color steps, same factored transfers, same recursion
    policy), float32."""
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy

    _, ml_t = problems
    hd = build_device_hierarchy(ml_t, device="cpu", dtype=torch.float32, fused=False, tail=False, sweeps=False)
    n = SLAB_N * SLAB_N
    b = torch.zeros(hd.fine_padded)
    b[:n] = torch.as_tensor(slab_rhs((SLAB_N, SLAB_N), 1).reshape(n), dtype=torch.float32)
    cycle = {"v": amt.V(), "w": amt.W(), "f": amt.F()}[cyc]
    want = _one_iteration(hd, cycle, torch.zeros_like(b), b).numpy()[:n].reshape(SLAB_N, SLAB_N)
    assert rel_err(_grid(results[4], ("float32", cyc)), want) < 2e-4


def test_sharded_general_smoothers(results):
    """Jacobi pre + backward SOR post: 4 slabs against one and against the
    single-device engine, float32."""
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy

    ml2 = slab_problem(amt, smoothers=True)
    hd = build_device_hierarchy(ml2, device="cpu", dtype=torch.float32)
    n = SLAB_N * SLAB_N
    b = torch.zeros(hd.fine_padded)
    b[:n] = torch.as_tensor(slab_rhs((SLAB_N, SLAB_N), 3).reshape(n), dtype=torch.float32)
    want = _one_iteration(hd, amt.V(), torch.zeros_like(b), b).numpy()[:n].reshape(SLAB_N, SLAB_N)
    got = _grid(results[4], ("smoothers", "v"))
    assert rel_err(got, want) < 2e-4
    assert rel_err(got, _grid(results[1], ("smoothers", "v"))) < SHARD_TOL["float32"]


def test_solve_lattice_sharded_converges(results):
    iters = {}
    for n_sh, res in results.items():
        for x, it, relres in (r["solve"] for r in res):
            assert relres < 1e-6 and it <= 25
            assert np.linalg.norm(x - 1.0) / np.sqrt(x.size) < 1e-4
            iters.setdefault(n_sh, set()).add(it)
        # every rank returns the whole solution
        assert all(np.array_equal(r["solve"][0], res[0]["solve"][0]) for r in res)
    assert all(len(v) == 1 for v in iters.values())
    assert len(set.union(*iters.values())) == 1, iters


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_ranks(failing_rank, 2, device="cpu", timeout_s=120)


def test_make_row_mesh_refusals():
    with pytest.raises(ValueError, match="backend"):
        make_row_mesh("mpi")
    with pytest.raises(RuntimeError, match="card"):
        make_row_mesh("nccl", init_method="tcp://127.0.0.1:1", world_size=64, rank=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_row_mesh()
    one = make_row_mesh(device="cpu")
    assert (one.rank, one.n_sh, one.backend, one.comm_stream) == (0, 1, "none", None)
