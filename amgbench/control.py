"""The readings a cell's limits are set from, at the cell's own size.

    python3 amgbench/control.py --workload <cell> --program-seeds S... --control-seeds S... [--reference-seeds S...]

from the root of a checkout, on the card.  Prints one JSON line a seed:

* ``program``: each right-hand side of the seed's pool answered once by the
  timed path (the cell's driver), judged as a run judges: the largest
  relative residual in the reference's float64 operator (the lower reading);
* ``control``: a whole run of the cell (``harness.run``) with the control,
  the reference put in the program's place in the precision below the
  configuration's (``drivers/reference_control.py``), answering the
  window's one request: its ``correct``, which has to be false, and its
  relative residual (the upper reading);
* ``reference``: the reference at the configuration's own precision, as the
  witness that the reference itself meets the limit.

The benchmark's own runs never run this.  ``amgbench/tests`` runs it at a
small size on the CPU and, marked ``gpu``, at the cell's size on a card.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def program_readings(p, seed):
    """Relative residuals of the timed path's answers to each right-hand
    side of the seed's pool, and whether the program reported success."""
    from amgbench import harness

    pool, request = harness.requests_for(p, seed)
    answers = [request(k) for k in range(len(pool))]
    relres = harness.relres_of(p, pool, answers)
    return {"relres": relres, "ok": [a.ok for a in answers]}


def reference_reading(p, seed, spec):
    """The reference solver's relative residual, in ``spec["dtype"]``, on
    the first right-hand side of the seed's pool, and its steps."""
    from amgbench.yardstick import rhs

    pool = rhs.make_pool(p.traffic["rhs"], p.traffic["pool"], p.n, seed, p.dev)
    b = p.torch.as_tensor(pool[0], device=p.dev)
    x, steps = p.reference.cg(b, p.dims, getattr(p.torch, spec["dtype"]), spec["tol"], spec["maxiter"])
    return p.reference.relres(x, b, p.dims), steps


def control_run(workload, seed, device, config_override=None):
    """A whole run of the cell with the control in the program's place and
    a window of one request."""
    from amgbench import harness

    return harness.run(workload, seed, 1e-3, False, device, time.perf_counter(), config_override,
                       driver="reference_control")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--program-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--reference-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [q for q in sys.path if os.path.abspath(q or ".") != here]
    sys.path.insert(0, str(ROOT))
    from amgbench import harness

    lines = []

    def emit(line):
        lines.append(line)
        print(json.dumps(line), flush=True)

    p = harness.prepare(args.workload, args.device)
    for seed in args.program_seeds:
        t = time.perf_counter()
        r = program_readings(p, seed)
        emit({"kind": "program", "seed": seed, "relres_max": max(r["relres"]), "all_ok": all(r["ok"]),
              "relres": r["relres"], "seconds": time.perf_counter() - t})
    witness = {**p.limits["control"], "dtype": p.limits["control"]["reference_dtype"]}
    for seed in args.reference_seeds:
        t = time.perf_counter()
        relres, steps = reference_reading(p, seed, witness)
        emit({"kind": "reference", "seed": seed, "dtype": witness["dtype"], "relres": relres, "steps": steps,
              "seconds": time.perf_counter() - t})
    limits = {k: v["limit"] for k, v in p.limits["checks"].items()}
    del p
    for seed in args.control_seeds:
        t = time.perf_counter()
        r = control_run(args.workload, seed, args.device)
        relres = r["checks"]["relres_max"]["value"]
        emit({"kind": "control", "seed": seed, "correct": r["correct"],
              "relres": relres if relres == relres else float("inf"), "seconds": time.perf_counter() - t})
    emit({"kind": "summary", "workload": args.workload,
          "lower": max((ln["relres_max"] for ln in lines if ln["kind"] == "program"), default=None),
          "upper": min((ln["relres"] for ln in lines if ln["kind"] == "control"), default=None),
          "limits": limits})
    return 0


if __name__ == "__main__":
    sys.exit(main())
