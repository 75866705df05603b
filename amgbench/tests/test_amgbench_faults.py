"""A whole run of each cell on the CPU at a small grid, past the look for a
card: sound, ``correct`` comes out true; with the timed path broken
underneath, false.  The faults a solve cell can have: a step that returns
its state unchanged (the zero guess), and an answer altered where it is
produced (one entry of x); a solve the program reports unconverged counts
as failed.  With the control in the program's place (the reference one
precision down), false.  The cells have no batch to halve and no exchange
between chips."""

import time

import pytest
import torch

import algebraicmultigrid_tpu_torch as amt
from algebraicmultigrid_tpu_torch.models import device as amg_device
from amgbench import control, harness

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
