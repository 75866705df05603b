"""The port's public API tier against the JAX package: every export of
``algebraicmultigrid_tpu.__all__`` is in the port's and is the same kind
of object; ``solve``/``init``/``AMGSolver`` with ``engine="torch",
device="cpu"`` give the iteration counts and residuals of the JAX
package's ``engine="jax"`` (float64: residual histories to 1e-10
relative); the reference's goldens through ``solve``, ``cg`` and
``aspreconditioner``; the preconditioner builders; the diagnostics
(``PhaseTimer``, ``cycle_work`` equal to the JAX package's; the
``torch.profiler`` trace and its phase ranges).  The smoother, GMG and
precision cases are in tests/test_torch_api_engines.py."""

import contextlib
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from conftest import load_csc
from test_golden_solutions import GOLDEN_CG, GOLDEN_SOLVE_1CYCLE, GOLDEN_SYMGS_1CYCLE

REPO = Path(__file__).resolve().parents[1]
TOL64 = 1e-10


def _kind(obj):
    if inspect.isclass(obj):
        return "class"
    if inspect.isfunction(obj) or inspect.isbuiltin(obj):
        return "function"
    return type(obj).__name__


@pytest.mark.parametrize("name", amg.__all__)
def test_export_is_the_same_kind_of_object(name):
    assert name in amt.__all__
    j, t = getattr(amg, name), getattr(amt, name)
    assert _kind(t) == _kind(j)
    assert getattr(t, "__name__", None) == getattr(j, "__name__", None)
    if inspect.isclass(j):
        assert [c.__name__ for c in inspect.getmro(t)] == [c.__name__ for c in inspect.getmro(j)]
    elif inspect.isfunction(j):
        # the port's signatures take at least the JAX package's parameters
        want = set(inspect.signature(j).parameters)
        assert want <= set(inspect.signature(t).parameters), name


def test_api_modules_leave_jax_unloaded():
    code = (
        "import sys, numpy as np, algebraicmultigrid_tpu_torch as amt\n"
        "from algebraicmultigrid_tpu_torch.utils import diagnostics\n"
        "A = amt.poisson(100)\n"
        "x = amt.solve(A, A @ np.ones(100), amt.RugeStubenAMG(), engine='torch', device='cpu')\n"
        "ml = amt.ruge_stuben(A, CF=amt.PMIS())\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'algebraicmultigrid_tpu.'))"
        " or m == 'algebraicmultigrid_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _hist_close(r_t, r_j, tol=TOL64):
    r_t, r_j = np.asarray(r_t), np.asarray(r_j)
    assert r_t.shape == r_j.shape
    assert np.max(np.abs(r_t - r_j)) <= tol * r_j[0]


@pytest.mark.parametrize("cycle", ["V", "W", "F"])
def test_rs_solve_matches_jax_engine(cycle):
    """RS on 20² through ``solve`` (ROADMAP A4: 7 = 7 iterations)."""
    A = amg.poisson((20, 20))
    b = A @ np.ones(A.shape[0])
    xj, rj = amg.solve(A, b, amg.RugeStubenAMG(), getattr(amg, cycle)(), engine="jax", reltol=1e-8, log=True)
    xt, rt = amt.solve(A, b, amt.RugeStubenAMG(), getattr(amt, cycle)(), engine="torch", device="cpu",
                       reltol=1e-8, log=True)
    assert len(rt) == len(rj) == 7
    _hist_close(rt, rj)
    assert np.abs(xt - xj).max() < 1e-12


def test_init_and_amgsolver_match_solve():
    A = amg.poisson((20, 20))
    b = A @ np.ones(A.shape[0])
    s_t = amt.init(amt.SmoothedAggregationAMG(), A, b)
    s_j = amg.init(amg.SmoothedAggregationAMG(), A, b)
    assert isinstance(s_t, amt.AMGSolver) and isinstance(s_t.ml, amt.MultiLevel)
    xt, rt = s_t.solve(amt.V(), engine="torch", device="cpu", reltol=1e-8, log=True)
    xj, rj = s_j.solve(amg.V(), engine="jax", reltol=1e-8, log=True)
    assert len(rt) == len(rj)
    _hist_close(rt, rj)
    x1 = amt.solve(A, b, amt.SmoothedAggregationAMG(), engine="torch", device="cpu", reltol=1e-8)
    assert np.array_equal(x1, s_t.solve(engine="torch", device="cpu", reltol=1e-8))
    with pytest.raises(TypeError):
        amt.init(object(), A, b)


def test_solve_keeps_the_torch_engine_keywords_off_the_setup():
    """``device``, ``coef_dtype`` and ``subcycle`` go to the solve (with no
    card, a dropped ``device="cpu"`` would raise there)."""
    from algebraicmultigrid_tpu_torch.models.api import _SOLVE_KWARGS

    assert {"device", "coef_dtype", "subcycle"} <= _SOLVE_KWARGS
    A = amg.poisson(100)
    x = amt.solve(A, A @ np.ones(100), amt.RugeStubenAMG(), engine="torch", device="cpu", reltol=1e-10)
    assert np.abs(x - 1).max() < 1e-8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            amt.solve(A, A @ np.ones(100), amt.RugeStubenAMG(), engine="torch")


def _b(n):
    b = np.zeros(n)
    b[0], b[1] = 1, -1
    return b


def test_goldens_through_the_port_api():
    """test_golden_solutions.py's goldens through ``amt.solve`` (host engine,
    forward GS), ``amt.cg`` with ``aspreconditioner`` and the torch engine's
    one cycle (symmetric GS, ROADMAP A4: 7e-13), beside the JAX engine."""
    thing = load_csc("thing")
    n = thing.shape[0]
    gs = amt.GaussSeidel(amt.ForwardSweep())
    x = amt.solve(thing, _b(n), amt.RugeStubenAMG(), presmoother=gs, postsmoother=gs, maxiter=1, abstol=1e-12,
                  coarse_solver=amt.Pinv)
    assert np.sum((x - GOLDEN_SOLVE_1CYCLE) ** 2) < 1e-8
    ml = amt.ruge_stuben(thing, presmoother=gs, postsmoother=gs, coarse_solver=amt.Pinv)
    x = amt.cg(thing, _b(n), M=amt.aspreconditioner(ml), tol=np.sqrt(np.finfo(np.float64).eps))
    assert np.sum((x - GOLDEN_CG) ** 2) < 1e-8
    xt = amt.solve(thing, _b(n), amt.RugeStubenAMG(), coarse_solver=amt.Pinv, engine="torch", device="cpu",
                   maxiter=1, reltol=1e-12, log=True)[0]
    xj = amg.solve(thing, _b(n), amg.RugeStubenAMG(), coarse_solver=amg.Pinv, engine="jax", maxiter=1,
                   reltol=1e-12, log=True)[0]
    assert np.sum((xt - GOLDEN_SYMGS_1CYCLE) ** 2) < 1e-8
    assert np.abs(xt - xj).max() < 1e-12


def test_preconditioner_device_apply_is_one_cycle():
    """``aspreconditioner(ml).device_apply_fn(device="cpu")`` applies one
    cycle from zero, as the host ``apply`` does, and feeds ``amt.cg``."""
    A = amt.poisson((30, 30))
    ml = amt.smoothed_aggregation(A)
    M = amt.aspreconditioner(ml)
    assert isinstance(M, amt.Preconditioner) and M.shape == A.shape
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    apply = M.device_apply_fn(device="cpu")
    y = apply(b)
    assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
    assert np.abs(y.numpy() - M.apply(b)).max() < 1e-12 * np.abs(M.apply(b)).max()
    x, res = amt.cg(A, b, M=lambda r: apply(r).numpy(), tol=1e-10, log=True)
    xh, resh = amt.cg(A, b, M=M, tol=1e-10, log=True)
    assert len(res) == len(resh) and np.abs(x - xh).max() < 1e-9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            M.device_apply_fn()


@pytest.mark.parametrize("builder", ["RugeStubenPreconBuilder", "SmoothedAggregationPreconBuilder"])
def test_precon_builders_match_jax(builder):
    A = sp.csr_matrix(amg.poisson((40, 40)))
    b = A @ np.ones(A.shape[0])
    Pl_t, Pr_t = getattr(amt, builder)(blocksize=1)(A)
    Pl_j, _ = getattr(amg, builder)(blocksize=1)(A)
    assert isinstance(Pl_t, amt.Preconditioner) and repr(Pr_t) == "I"
    xt, rt = amt.cg(A, b, M=Pl_t, tol=1e-8, log=True)
    xj, rj = amg.cg(A, b, M=Pl_j, tol=1e-8, log=True)
    assert len(rt) == len(rj)
    _hist_close(rt, rj, 1e-12)
    assert repr(getattr(amt, builder)(blocksize=2, max_levels=3)) == repr(getattr(amg, builder)(blocksize=2, max_levels=3))


def _phase_log(pkg, timer):
    from importlib import import_module

    A = pkg.poisson((30, 30))
    with timer.phase("setup"):
        ml = pkg.ruge_stuben(A)
    for _ in range(3):
        with timer.phase("cycle"):
            pkg.solve_mg(ml, A @ np.ones(A.shape[0]), maxiter=1)
    with import_module(f"{pkg.__name__}.utils.diagnostics").PhaseTimer(enabled=False).phase("off"):
        pass
    return ml


def test_phase_timer_and_cycle_work_match_jax():
    from algebraicmultigrid_tpu.utils.diagnostics import PhaseTimer as PT_j, cycle_work as cw_j
    from algebraicmultigrid_tpu_torch.utils.diagnostics import PhaseTimer as PT_t, cycle_work as cw_t

    t_j, t_t = PT_j(), PT_t()
    ml_j, ml_t = _phase_log(amg, t_j), _phase_log(amt, t_t)
    assert dict(t_t.counts) == dict(t_j.counts) == {"setup": 1, "cycle": 3}
    assert t_t.report().splitlines()[0] == t_j.report().splitlines()[0]
    assert set(t_t.totals) == set(t_j.totals)
    lat_j = amg.structured_smoothed_aggregation(amg.poisson((96, 96), lattice=True), proxy=32, cut_rows=500,
                                                min_proxy_dim=12)
    lat_t = amt.structured_smoothed_aggregation(amt.poisson((96, 96), lattice=True), proxy=32, cut_rows=500,
                                                min_proxy_dim=12)
    for a, b in ((ml_j, ml_t), (lat_j, lat_t)):
        for cyc in ("V", "W", "F"):
            assert cw_t(b, cyc) == cw_j(a, cyc) > 0


def test_profile_trace_names_the_cycle_phases(tmp_path):
    """Inside ``profile_trace`` the device cycle opens its phase ranges
    under the JAX package's scope names; with no profiler recording it
    opens none."""
    from algebraicmultigrid_tpu_torch.utils import diagnostics as dg

    A = amt.poisson((30, 30))
    jac = amt.Jacobi(0.7)
    ml = amt.ruge_stuben(A, presmoother=jac, postsmoother=jac, max_levels=3)
    apply = amt.device_cycle_fn(ml, device="cpu")
    b = A @ np.ones(A.shape[0])
    apply(b)
    assert isinstance(dg.phase_range("L0/down"), type(contextlib.nullcontext()))
    with dg.profile_trace(str(tmp_path)) as prof:
        assert isinstance(dg.phase_range("L0/down"), torch.profiler.record_function)
        apply(b)
    names = {e.key for e in prof.key_averages()}
    n_lvl = len(ml.levels)
    want = {f"L{l}/{p}" for l in range(n_lvl) for p in ("presmooth", "residual", "restrict", "prolong", "postsmooth")}
    assert want | {"coarse_solve"} <= names
    assert (tmp_path / "trace.json").stat().st_size > 0
