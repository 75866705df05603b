"""Nothing the benchmark runs loads JAX or the JAX package, compared by each
module's whole top-level name (the port's own name begins with the JAX
package's); the reference imports nothing of the program; without a card
the entry point exits non-zero and prints no result."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "amgbench"
BANNED = {"jax", "jaxlib", "flax", "algebraicmultigrid_tpu"}
PORT = "algebraicmultigrid_tpu_torch"


def imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for f in BENCH.rglob("*.py"):
        assert not imported_top_names(f) & BANNED, f


def test_the_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        assert not imported_top_names(f) & (BANNED | {PORT, "amgbench"}), f


def test_a_whole_run_loads_no_banned_module():
    """A small run on the CPU in a fresh process, then its modules."""
    script = f"""
import sys, time, json
sys.path.insert(0, {str(ROOT)!r})
from amgbench import harness
from amgbench.tests.test_amgbench_faults import small_run
r = small_run("reloaded-solve", trace=True)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PORT in loaded and not loaded & BANNED


def test_without_a_card_the_entry_exits_non_zero_with_no_result(tmp_path):
    """Here (no card), and in a directory holding only BENCHMARK.json and
    the benchmark's files (no program)."""
    cmd = [sys.executable, "amgbench/run.py", "--workload", "flagship-solve", "--seed", "1", "--seconds", "1"]
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    shutil.copytree(BENCH, bare / "amgbench", ignore=shutil.ignore_patterns("__pycache__"))
    for where in (ROOT, bare):
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=where,
                             env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0 and out.stdout.strip() == "", (where, out.stdout[-500:])
