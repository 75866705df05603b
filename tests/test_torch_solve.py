"""The port's cycle and solve drivers against the JAX package's: one cycle
in float64 to relative 1e-10, AMG-PCG with equal iteration counts in
float64 and float32, and mixed-precision refinement to 1e-8 in the same
number of rounds."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from torch_port_common import N, PLAIN_TILES, jax_env, jax_hierarchy_to_numpy, rel_err, setup_both

TOL = 1e-10


@pytest.fixture(scope="module")
def problem():
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy as build_t

    ml_j, ml_t = setup_both()
    with jax_env(**PLAIN_TILES):
        h_fused = build_j(ml_j, dtype=jnp.float64)
    h_plain = build_j(ml_j, dtype=jnp.float64)
    assert all(L.fused is not None for L in h_fused.levels)
    assert all(L.fused is None for L in h_plain.levels)
    levels, coarse = jax_hierarchy_to_numpy(h_fused)
    ports = {
        "converted": hierarchy_from_numpy(levels, coarse, device="cpu", dtype=torch.float64),
        "built": build_t(ml_t, device="cpu", dtype=torch.float64),
        "built_unfused": build_t(ml_t, device="cpu", dtype=torch.float64, fused=False),
    }
    return ml_j, ml_t, h_fused, h_plain, ports


def _rhs(pad, seed=0):
    b = np.zeros(pad)
    b[: N * N] = np.random.default_rng(seed).standard_normal(N * N)
    return b


def _port_cycle(h, cycle, b):
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration

    x0 = torch.zeros(h.fine_padded, dtype=torch.float64)
    return _one_iteration(h, cycle, x0, torch.as_tensor(b)).numpy()


def test_vcycle_matches_jax_fused_legs(problem):
    from algebraicmultigrid_tpu.models.device import _one_iteration

    _, _, h_fused, _, ports = problem
    b = _rhs(h_fused.fine_padded)
    x_j = np.asarray(_one_iteration(h_fused, amg.V(), jnp.zeros(b.shape[0]), jnp.asarray(b)))
    for h in ports.values():
        assert rel_err(_port_cycle(h, amt.V(), b), x_j) < TOL


@pytest.mark.parametrize("cyc", ["W", "F"])
def test_cycle_matches_jax_unfused(problem, cyc):
    from algebraicmultigrid_tpu.models.device import _one_iteration

    _, _, _, h_plain, ports = problem
    b = _rhs(h_plain.fine_padded, seed=1)
    x_j = np.asarray(_one_iteration(h_plain, getattr(amg, cyc)(), jnp.zeros(b.shape[0]), jnp.asarray(b)))
    for h in ports.values():
        assert rel_err(_port_cycle(h, getattr(amt, cyc)(), b), x_j) < TOL


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cg_device_iteration_counts_match(problem, dtype):
    from algebraicmultigrid_tpu.models.device import cg_device as cg_j

    ml_j, ml_t, *_ = problem
    b = np.random.default_rng(2).standard_normal(N * N)
    x_j, it_j, nr_j = cg_j(ml_j, b, dtype=dtype, log=True)
    x_t, it_t, nr_t = amt.cg_device(ml_t, b, device="cpu", dtype=getattr(torch, dtype), log=True)
    assert it_t == it_j
    assert nr_t <= 1e-8 * np.linalg.norm(b) and nr_j <= 1e-8 * np.linalg.norm(b)
    assert rel_err(x_t, x_j) < (1e-10 if dtype == "float64" else 1e-4)


def test_solve_refined_matches_jax_rounds(problem):
    from algebraicmultigrid_tpu.models.device import solve_refined as refine_j

    ml_j, ml_t, *_ = problem
    b = np.random.default_rng(3).standard_normal(N * N)
    x_j, hist_j = refine_j(ml_j, b, tol=1e-8, log=True)
    stats = {}
    x_t, hist_t = amt.solve_refined(ml_t, b, tol=1e-8, device="cpu", log=True, stats=stats)
    assert len(hist_t) == len(hist_j)
    assert len(stats["inner_iters"]) == len(hist_t) - 1
    A = ml_t.levels[0].A
    for x in (x_t, x_j):
        assert np.linalg.norm(b - A @ np.asarray(x)) / np.linalg.norm(b) < 1e-8


def test_build_rejects_non_lattice_levels():
    """Non-lattice levels lower to the general formats; the builder rejects
    one only for a smoother it cannot run."""
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.lattice_op import Lat2D

    ml = amt.smoothed_aggregation(amt.poisson((24, 24)))
    h = build_device_hierarchy(ml, device="cpu", dtype=torch.float64)
    assert not any(isinstance(L.A, Lat2D) for L in h.levels)
    ml.levels[0].presmoother_config = "not a smoother"
    with pytest.raises(TypeError):
        build_device_hierarchy(ml, device="cpu", dtype=torch.float64)


def test_default_device_is_the_card_never_the_cpu(monkeypatch):
    """With no ``device`` the engine picks the card and raises without one;
    the CPU runs only when asked for."""
    from algebraicmultigrid_tpu_torch.models.device import _resolve

    ml = amt.smoothed_aggregation(amt.poisson((24, 24)))
    b = np.ones(ml.levels[0].A.shape[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: amt.get_device_hierarchy(ml),
        lambda: amt.cg_device(ml, b),
        lambda: amt.solve_refined(ml, b),
        lambda: amt.solve_device(ml, b),
        lambda: amt.device_cycle_fn(ml),
        lambda: ml.solve(b, engine="torch"),
    ):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
    assert _resolve(ml, "cpu", None) == (torch.device("cpu"), torch.float64)
    assert _resolve(ml, "cpu", "float32") == (torch.device("cpu"), torch.float32)
