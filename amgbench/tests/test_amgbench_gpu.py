"""The readings at each cell's own size, on a card (marked ``gpu``; they
skip without one):

    python -m pytest amgbench/tests -m gpu -rP

For each cell, on three seeds: the timed path's answers read under the
cell's limit and are all reported converged; a whole run with the control
in the program's place (the reference one precision down) comes out not
correct, reading above the limit.  ``-rP`` shows each reading."""

import json
from pathlib import Path

import pytest

SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]
CELLS = ["flagship-solve", "flagship-cycles", "reloaded-solve"]
LIMITS = Path(__file__).resolve().parents[1] / "limits"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_run_fails_at_the_cells_size(cell, capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the readings are taken at the cells' own size")
    from amgbench import control

    assert control.main(["--workload", cell, "--program-seeds", *map(str, SEEDS),
                         "--control-seeds", *map(str, SEEDS)]) == 0
    out = capsys.readouterr().out
    print(out)
    lines = [json.loads(s) for s in out.strip().splitlines()]
    summary = lines[-1]
    limit = json.loads((LIMITS / f"{cell}.json").read_text())["checks"]["relres_max"]["limit"]
    assert summary["lower"] <= limit < summary["upper"]
    assert all(ln["all_ok"] for ln in lines if ln["kind"] == "program")
    assert [ln["correct"] for ln in lines if ln["kind"] == "control"] == [False] * len(SEEDS)
