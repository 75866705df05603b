"""A whole run of each cell on the CPU at a small grid, past the look for a
card: sound, ``correct`` comes out true; with the timed path broken
underneath, false.  The faults a solve cell can have: a step that returns
its state unchanged (the zero guess), and an answer altered where it is
produced (one entry of x); a solve the program reports unconverged counts
as failed.  With the control in the program's place (the reference one
precision down), false.  The cells have no batch to halve and no exchange
between chips.  A 3-D lattice runs through the same harness by a
configuration override alone: the harness takes a grid of any dimension."""

import math
import time

import pytest
import torch

import algebraicmultigrid_tpu_torch as amt
from algebraicmultigrid_tpu_torch.models import device as amg_device
from amgbench import control, harness
from amgbench.yardstick import rhs

SMALL = {"grid": [192, 192]}
# the proxy sizes that keep 192² on the structured path (every level a lattice)
PROXY = {"proxy": 64, "cut_rows": 2000, "min_proxy_dim": 16}
SEED = 2**31 + 77
CELLS = ["flagship-solve", "flagship-cycles", "reloaded-solve"]


def small_override(cell):
    _, entry, _, _ = harness.find_cell(cell)
    config = harness.load_config(entry)
    return {"problem": {**config["problem"], **SMALL}, "setup": {**config["setup"], **PROXY}}


def small_run(cell, seconds=0.3, trace=False):
    return harness.run(cell, SEED, seconds, trace, "cpu", time.perf_counter(), config_override=small_override(cell))


def altered(x):
    x = x.clone() if isinstance(x, torch.Tensor) else x.copy()
    x[len(x) // 3] += 1e-2 * abs(x).max()
    return x


def unchanged(x):
    return 0 * x


def break_path(monkeypatch, cell, fault):
    """Plant ``fault`` at the place the cell's answer is produced."""
    if cell != "flagship-cycles":
        real = amt.solve_refined

        def solve_refined(*a, **kw):
            x, history = real(*a, **kw)
            return fault(x), history

        monkeypatch.setattr(amt, "solve_refined", solve_refined)
    else:
        real = amg_device.run_fixed_cycles
        monkeypatch.setattr(amg_device, "run_fixed_cycles", lambda h, x, b, n: fault(real(h, x, b, n)))


def report_unconverged(monkeypatch):
    """The program's residual history ends where it began."""
    real = amt.solve_refined

    def solve_refined(*a, **kw):
        x, history = real(*a, **kw)
        return x, history + history[:1]

    monkeypatch.setattr(amt, "solve_refined", solve_refined)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = small_run(cell)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks" and r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("fault", [unchanged, altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    break_path(monkeypatch, cell, fault)
    r = small_run(cell)
    assert r["correct"] is False
    assert r["checks"]["relres_max"]["value"] > r["checks"]["relres_max"]["limit"]


@pytest.mark.parametrize("cell", ["flagship-solve", "reloaded-solve"])
def test_unconverged_solve_counts_as_failed(cell, monkeypatch):
    report_unconverged(monkeypatch)
    r = small_run(cell)
    assert r["correct"] is False and r["failed"] == r["attempted"] >= 1
    assert r["checks"]["relres_max"]["value"] <= r["checks"]["relres_max"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_run_is_not_correct(cell):
    """The control through a whole run: the reference's conjugate gradients
    one precision down in the program's place, judged as the program is."""
    r = control.control_run(cell, SEED, "cpu", small_override(cell))
    assert r["correct"] is False and r["attempted"] == 1
    assert r["checks"]["relres_max"]["value"] > r["checks"]["relres_max"]["limit"]


def test_traced_run_reads_host_metrics_and_no_device_metric():
    """On the CPU the profiler sees no device: the device readers return
    nothing and their metrics are left out of the line."""
    r = small_run("flagship-solve", trace=True)
    assert r["correct"] is True
    assert {"setup.hierarchy_s", "setup.lowering_s", "solve.pcg_iters"} == set(r["metrics"])
    assert r["metrics"]["solve.pcg_iters"]["value"] > 0 and "breakdown" in r


# a 3-D lattice through the N-D set-up route, at proxy sizes that keep L0 a
# LatND (the 7-point operator K7 sweeps)
GRID_3D = [48, 48, 48]
OVERRIDE_3D = {
    "problem": {"gallery": "poisson", "grid": GRID_3D, "lattice": True, "unknowns": math.prod(GRID_3D)},
    "setup": {"route": "structured_sa_nd", "proxy": 24, "cut_rows": 2000},
}


def run_3d(seconds=0.3):
    return harness.run("flagship-solve", SEED, seconds, False, "cpu", time.perf_counter(), config_override=OVERRIDE_3D)


def test_3d_lattice_sound_run_is_correct(monkeypatch):
    """The pool's rows have an entry a cell of the whole grid, L0 lowers to
    LatND, and the sound run reads correct."""
    shapes, levels = [], []
    make_pool, lower = rhs.make_pool, amt.get_device_hierarchy

    def recording_pool(spec, pool, n, seed, device):
        out = make_pool(spec, pool, n, seed, device)
        shapes.append(tuple(out.shape))
        return out

    def recording_lower(*a, **kw):
        h = lower(*a, **kw)
        levels.append(type(h.levels[0].A).__name__)
        return h

    monkeypatch.setattr(rhs, "make_pool", recording_pool)
    monkeypatch.setattr(amt, "get_device_hierarchy", recording_lower)
    r = run_3d()
    assert shapes == [(64, math.prod(GRID_3D))] and levels == ["LatND"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["relres_max"]["value"] <= r["checks"]["relres_max"]["limit"]


@pytest.mark.parametrize("fault", [unchanged, altered])
def test_3d_lattice_broken_path_is_not_correct(fault, monkeypatch):
    break_path(monkeypatch, "flagship-solve", fault)
    r = run_3d()
    assert r["correct"] is False
    assert r["checks"]["relres_max"]["value"] > r["checks"]["relres_max"]["limit"]


def test_3d_lattice_control_run_is_not_correct():
    r = control.control_run("flagship-solve", SEED, "cpu", OVERRIDE_3D)
    assert r["correct"] is False and r["attempted"] == 1
    assert r["checks"]["relres_max"]["value"] > r["checks"]["relres_max"]["limit"]
