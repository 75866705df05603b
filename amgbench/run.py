"""Run one cell of the benchmark on this machine's card.

    python3 amgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the cell's set-up and window on
standard error, each number that decides ``correct`` beside its limit as the
last lines there, and one JSON object as the last line of standard output.
Exits non-zero, with no result, where there is no CUDA card or fewer than
the cell asks for.  The program's caches stay inside the checkout: its
kernel library in ``algebraicmultigrid_tpu_torch/_build/``, any torch
extension or Triton cache under ``.amgbench_cache/``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".amgbench_cache"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    # run from the checkout's root whatever the script's own directory
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))

    from amgbench import harness

    cell = harness.find_cell(args.workload)[0]
    import torch

    t_import = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {cell['chips']} CUDA card(s); this machine has {found}", file=sys.stderr)
        return 2
    found = time.perf_counter() - t_import
    print(f"startup (s): python and torch imported {t_import - T_PROCESS!r}, card found {found!r}", file=sys.stderr)
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
