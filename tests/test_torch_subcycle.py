"""The phased whole-subcycle V-cycle (K9): the port's gate against the JAX
package's, its plain version against the JAX ``fused_subcycle`` in interpret
mode (float64, relative 1e-10) on the JAX cache carried across and on the
port's own, its wiring into the V-cycle, ``run_fixed_cycles`` and
``cg_device``, and ``hierarchy_from_numpy`` carrying it.  The problem is
the 192² structured-SA Poisson of ``torch_port_common`` with the tail
limited to 600 rows (the JAX package's ``AMG_TAIL_MAX_ROWS=600``): L0 192²,
L1 64² (the sub level), L2 22² and L3 8² (the tail).  The CUDA kernel is
held against the plain version on the card by tests/test_torch_cuda.py."""

import functools
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from torch_port_common import (
    N, PLAIN_TILES, SETUP_KW, jax_env, jax_hierarchy_to_numpy, jax_sub_to_numpy, jax_tail_to_numpy, rel_err,
    setup_both,
)

TAIL_ROWS = 600
TOL = 1e-10


def _vec(n, pad, seed):
    v = np.zeros(pad)
    v[:n] = np.random.default_rng(seed).standard_normal(n)
    return v


def _build(ml, **kw):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy

    return build_device_hierarchy(ml, device="cpu", dtype=torch.float64, **kw)


@pytest.fixture(scope="module")
def problem():
    """Both setups, the JAX hierarchy with its sub cache (legs, tail and sub
    switched on) and the JAX kernel's and V-cycle's outputs, computed once."""
    from algebraicmultigrid_tpu.models.device import _one_iteration
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j
    from algebraicmultigrid_tpu.ops.pallas.subcycle_kernel import fused_subcycle

    ml_j, ml_t = setup_both()
    with jax_env(AMG_PALLAS_TAIL="1", AMG_PALLAS_SUB="1", AMG_TAIL_MAX_ROWS=str(TAIL_ROWS), **PLAIN_TILES):
        h_j = build_j(ml_j, dtype=jnp.float64)
    L1 = h_j.levels[1].A
    b1 = _vec(L1.shape[0], L1.rows_padded, 1)
    b0 = _vec(N * N, h_j.fine_padded, 2)
    return types.SimpleNamespace(
        ml_j=ml_j, ml_t=ml_t, h_j=h_j, b1=b1, b0=b0,
        y_sub=np.asarray(fused_subcycle(h_j.sub, jnp.asarray(b1))),
        y_cycle=np.asarray(_one_iteration(h_j, amg.V(), jnp.zeros(b0.shape[0]), jnp.asarray(b0))),
    )


@pytest.fixture(scope="module")
def ports(problem):
    """The port's own hierarchy with the subcycle, the same without it, and
    the JAX hierarchy carried across with its tail and sub caches."""
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy

    h_j = problem.h_j
    levels, coarse = jax_hierarchy_to_numpy(h_j)
    return types.SimpleNamespace(
        own=_build(problem.ml_t, tail_max_rows=TAIL_ROWS, subcycle=True),
        nosub=_build(problem.ml_t, tail_max_rows=TAIL_ROWS),
        conv=hierarchy_from_numpy(
            levels, coarse, device="cpu", dtype=torch.float64,
            tail=jax_tail_to_numpy(h_j), tail_start=h_j.tail_start,
            sub=jax_sub_to_numpy(h_j), sub_start=h_j.sub_start,
        ),
    )


@pytest.mark.parametrize("rows", [TAIL_ROWS, 5000, 250_000])
def test_hierarchy_gate_matches_jax(problem, rows):
    """sub_start/tail_start as the JAX package gives them: the sub level
    above a tail at L2; none where the tail starts at L1 or L0."""
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j

    if rows == TAIL_ROWS:
        h_j = problem.h_j
    else:
        with jax_env(AMG_PALLAS_TAIL="1", AMG_PALLAS_SUB="1", AMG_TAIL_MAX_ROWS=str(rows)):
            h_j = build_j(problem.ml_j, dtype=jnp.float64)
    h = _build(problem.ml_t, tail_max_rows=rows, subcycle=True)
    assert (h.tail_start, h.sub_start) == (h_j.tail_start, h_j.sub_start)
    assert (h.sub is None) == (h_j.sub is None)
    want = {TAIL_ROWS: (2, 1), 5000: (1, -1), 250_000: (0, -1)}[rows]
    assert (h.tail_start, h.sub_start) == want
    if h.sub is not None:
        assert h.sub.top is h.levels[1].fused and h.sub.tail is h.tail
    assert _build(problem.ml_t, tail_max_rows=rows).sub is None  # off by default


@pytest.mark.parametrize("case", ["built", "start_out_of_range", "too_many_rows", "last_level", "fwd_bwd"])
def test_builder_refuses_like_jax(problem, case):
    """``build_fused_subcycle_cache`` gives None exactly where the JAX
    builder does."""
    from algebraicmultigrid_tpu.ops.pallas.subcycle_kernel import build_fused_subcycle_cache as build_sub_j
    from algebraicmultigrid_tpu_torch.ops.kernels.subcycle_kernel import build_fused_subcycle_cache

    ml_j, ml_t = problem.ml_j, problem.ml_t
    start, kw = 1, {}
    if case == "start_out_of_range":
        start = len(ml_t.levels)
    elif case == "too_many_rows":
        kw = dict(max_rows=ml_t.levels[1].A.shape[0] - 1)
    elif case == "last_level":
        start = len(ml_t.levels) - 1
    elif case == "fwd_bwd":
        ml_j, ml_t = (
            pkg.structured_smoothed_aggregation(
                pkg.poisson((N, N), lattice=True), aggregate=pkg.StructuredAggregation(box=3), **SETUP_KW,
                presmoother=pkg.GaussSeidel(ordering="multicolor", sweep=pkg.ForwardSweep()),
                postsmoother=pkg.GaussSeidel(ordering="multicolor", sweep=pkg.BackwardSweep()),
            )
            for pkg in (amg, amt)
        )
    got = build_fused_subcycle_cache(ml_t.levels, ml_t, start, torch.float64, "cpu", **kw)
    if case == "built":
        assert problem.h_j.sub is not None and got is not None
        assert got.top.row_dims == (64, 64) and got.tail.levels[0].row_dims == (22, 22)
        return
    want = build_sub_j(ml_j.levels, ml_j, start, jnp.float64, interpret=True, **kw)
    assert want is None and got is None


def test_reference_matches_jax_kernel(problem, ports):
    """The plain version on the JAX cache carried across and on the port's
    own cache against the JAX kernel (interpret mode), float64."""
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.kernels.subcycle_kernel import fused_subcycle, fused_subcycle_reference

    b = torch.as_tensor(problem.b1)
    before = dict(vl.launches)
    for h in (ports.conv, ports.own):
        assert h.sub_start == 1
        y = fused_subcycle_reference(h.sub, b)
        assert y.shape == b.shape
        assert rel_err(y, problem.y_sub[: b.shape[0]]) < TOL
        assert torch.equal(fused_subcycle(h.sub, b), y)  # a CPU tensor runs the plain version
    assert vl.launches == before


def test_vcycle_matches_jax_and_the_unsubbed_cycle(problem, ports):
    """One V-cycle with the subcycle against the JAX V-cycle with
    AMG_PALLAS_SUB=1, and against the port's V-cycle without it."""
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration

    b = torch.as_tensor(problem.b0)
    ys = {name: _one_iteration(h, amt.V(), torch.zeros_like(b), b) for name, h in vars(ports).items()}
    assert ys["own"].shape == b.shape
    for name in ("own", "conv"):
        assert rel_err(ys[name], problem.y_cycle) < TOL
    assert rel_err(ys["own"], ys["nosub"]) < 1e-12


@pytest.mark.parametrize("cycle", [amt.F(), amt.W()])
def test_other_cycles_keep_the_levels(problem, ports, cycle):
    """W and F cycles do not take the subcycle: an F cycle's V pass reaches
    the sub level with a nonzero x, which the subcycle (from zero) would
    drop."""
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration

    b = torch.as_tensor(problem.b0)
    y = _one_iteration(ports.own, cycle, torch.zeros_like(b), b)
    assert rel_err(y, _one_iteration(ports.nosub, cycle, torch.zeros_like(b), b)) < 1e-12


def test_fixed_cycles_match_iterated_cycles(problem, ports):
    """run_fixed_cycles (down, then per cycle the subcycle and the updown
    leg) against iterated V-cycles of the same hierarchy, float64."""
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, run_fixed_cycles

    b = torch.as_tensor(problem.b0)
    x = torch.zeros_like(b)
    for _ in range(3):
        x = _one_iteration(ports.own, amt.V(), x, b)
    assert rel_err(run_fixed_cycles(ports.own, torch.zeros_like(b), b, 3), x) < TOL


def test_cg_device_iterations_unchanged(problem, monkeypatch):
    """cg_device(subcycle=True) takes as many iterations as without it (the
    drivers' hierarchy with the tail limited to 600 rows, as the JAX
    package's AMG_TAIL_MAX_ROWS would)."""
    from algebraicmultigrid_tpu_torch.models import device as dev

    monkeypatch.setattr(dev, "build_device_hierarchy", functools.partial(dev.build_device_hierarchy, tail_max_rows=TAIL_ROWS))
    ml = problem.ml_t
    b = np.random.default_rng(3).standard_normal(N * N)
    try:
        assert dev.get_device_hierarchy(ml, "cpu", torch.float64, subcycle=True).sub_start == 1
        runs = [
            amt.cg_device(ml, b, tol=1e-8, device="cpu", dtype=torch.float64, log=True, subcycle=sub)
            for sub in (True, False)
        ]
    finally:
        ml._device_cache.clear()
    (x1, it1, _), (x0, it0, _) = runs
    assert it1 == it0 and it1 > 0
    assert rel_err(x1, x0) < 1e-9


def test_hierarchy_from_numpy_carries_sub(problem, ports):
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy

    conv, own = ports.conv, ports.own
    assert (conv.tail_start, conv.sub_start) == (2, 1)
    assert conv.sub.tail is conv.tail
    for name in ("A", "dinv", "T", "S"):
        assert rel_err(getattr(conv.sub.top, name), getattr(own.sub.top, name)) < 1e-14
    assert conv.sub.steps == own.sub.steps == problem.h_j.sub.steps
    levels, coarse = jax_hierarchy_to_numpy(problem.h_j)
    with pytest.raises(ValueError):  # the sub level must sit right above the tail
        hierarchy_from_numpy(
            levels, coarse, device="cpu", dtype=torch.float64, tail=jax_tail_to_numpy(problem.h_j),
            tail_start=2, sub=jax_sub_to_numpy(problem.h_j), sub_start=0,
        )


def test_wrapper_refuses_other_devices(ports):
    from algebraicmultigrid_tpu_torch.ops.kernels.subcycle_kernel import fused_subcycle

    with pytest.raises(ValueError):
        fused_subcycle(ports.own.sub, torch.zeros(64 * 64, dtype=torch.float64, device="meta"))
