"""``BENCHMARK.json`` against the benchmark's contract, and every file a
cell needs found by name."""

import importlib
import json
import re
from pathlib import Path

import pytest

from amgbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "amgbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line_ok(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_command_and_paths():
    assert set(MANIFEST) == TOP_KEYS
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(line_ok(w) for w in cmd)
    named = [w for w in cmd if "/" in w or w.endswith(".py")]
    assert all(any(w == p or w.startswith(p + "/") for p in MANIFEST["paths"]) for w in named)
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {c["config"] for c in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"].startswith("amgbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        held = json.loads((ROOT / c["file"]).read_text())
        assert held["name"] == c["name"] and held["source"] == c["source"] and held["reduced"] == c["reduced"]
    sources = [c["source"] for c in MANIFEST["configs"]]
    assert len(sources) == len(set(sources))


def test_workloads():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert 1 <= len(pairs) <= 24 and len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(pairs) // 4)
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line_ok(w["why"]) and NAME.match(w["traffic"])


def test_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and line_ok(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        mine = [m for m in MANIFEST["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(cell in m.get("workloads", cells) for m in MANIFEST["per_layer"])


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_found_by_name(cell):
    w = next(x for x in MANIFEST["workloads"] if x["name"] == cell)
    entry = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    assert {"problem", "setup", "precision", "guarantees", "reference"} <= set(config)
    for module in (f"amgbench.drivers.{traffic['driver']}", f"amgbench.setups.{config['setup']['route']}",
                   f"amgbench.reference.{config['reference']}"):
        importlib.import_module(module)
    assert {"relres_max", "failed"} <= set(limits["checks"]) and "control" in limits
    for m in MANIFEST["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert harness.reader_path(m["name"]).is_file()


def test_every_file_under_paths_is_named_from_name_characters():
    for f in BENCH.rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        assert PATH.match(str(f.relative_to(ROOT))), f
