"""The benchmark's run of one cell: set-up, the measured window, the
per-layer readings of a traced run, and the comparison that decides
``correct``.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration's file (``configs/<name>.json``, naming its set-up route
``setups/<route>.py`` and its plain reference ``reference/<name>.py``), its
traffic file (``traffic/<name>.json``, naming its driver
``drivers/<driver>.py``), its limits (``limits/<cell>.json``), and a
reader for each per-layer metric (``metrics/<metric>.py``, or one reader
for a family of metrics, ``metrics/<name before the first dot>.py``).  A
cell added with new files and entries runs without an edit here, on a
lattice configuration of any dimension: the right-hand sides have one entry
a cell of the whole grid, and the reference takes the grid as it is.
"""

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import random
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

from amgbench.yardstick import rhs, trace

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# modules that must not be loaded in the process that prints a result,
# compared by their whole top-level name: JAX, and the JAX package the port
# was made from (whose name the port's own begins with)
BANNED = ("jax", "jaxlib", "flax", "algebraicmultigrid_tpu")
WARMUP_REQUESTS = 2
KEPT_ANSWERS = 8


@dataclasses.dataclass
class Answer:
    """What one request gave: the answer (a tensor or numpy array), the
    pool index of its right-hand side, whether the program reported
    success, and counts the program made on the way."""

    value: Any
    index: int
    ok: bool
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def manifest():
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(name: str, bench=None):
    """(cell, configuration entry, end-to-end metrics, per-layer metrics) of
    the cell ``name``; the metrics are those the manifest gives this cell."""
    bench = bench or manifest()
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(m):
        return name in m.get("workloads", [name])

    return cell, config, [m for m in bench["end_to_end"] if mine(m)], [m for m in bench["per_layer"] if mine(m)]


def reader_path(metric: str) -> Path:
    """``metrics/<metric>.py`` where there is one, else the family's reader
    ``metrics/<metric's name before the first dot>.py`` (``idle_pct.solve``
    and ``idle_pct.cycles`` share ``idle_pct.py``)."""
    own = BENCH / "metrics" / f"{metric}.py"
    return own if own.is_file() else BENCH / "metrics" / f"{metric.split('.')[0]}.py"


def load_reader(metric: str):
    """The per-layer metric's reader: ``read`` of its ``reader_path``."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location("amgbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Keeper:
    """A sample of the window's answers, drawn from the seed (a reservoir:
    each answer is equally likely to be kept).  Device answers are copied
    into buffers made at set-up, so keeping one allocates nothing in the
    window; host answers are kept by reference."""

    def __init__(self, seed: int, slots: int):
        self.rng = random.Random(seed)
        self.slots = slots
        self.seen = 0
        self.kept: List[Optional[Answer]] = [None] * slots
        self.buffers = None

    def reserve(self, like: Answer, torch):
        if isinstance(like.value, torch.Tensor):
            v = like.value
            self.buffers = torch.empty((self.slots, *v.shape), dtype=v.dtype, device=v.device)

    def offer(self, ans: Answer):
        slot = self.seen if self.seen < self.slots else self.rng.randrange(self.seen + 1)
        self.seen += 1
        if slot >= self.slots:
            return
        value = ans.value
        if self.buffers is not None:
            self.buffers[slot].copy_(value)
            value = self.buffers[slot]
        self.kept[slot] = Answer(value, ans.index, ans.ok)

    def answers(self) -> List[Answer]:
        return [a for a in self.kept if a is not None]


def run_window(request, seconds: float, keeper: Keeper, traced: bool = False):
    """Requests one after another (a closed loop, one client) until
    ``seconds`` have passed; the window ends when the last one returns.
    A traced window marks itself and each request with a profiler range."""
    import torch

    def span(name):
        return torch.profiler.record_function(name) if traced else contextlib.nullcontext()

    times, counters = [], {}
    attempted = failed = 0
    first_error = None
    gc.collect()
    gc.disable()  # no collector pause inside the window
    try:
        with span(trace.WINDOW_RANGE):
            t_start = t_end = time.perf_counter()
            while t_end - t_start < seconds:
                k = attempted
                attempted += 1
                t0 = time.perf_counter()
                try:
                    with span("amgbench/request"):
                        ans = request(k)
                except Exception:  # a request that raises counts as failed; the run goes on
                    failed += 1
                    first_error = first_error or traceback.format_exc()
                    t_end = time.perf_counter()
                    continue
                t_end = time.perf_counter()
                times.append(t_end - t0)
                if not ans.ok:
                    failed += 1
                keeper.offer(ans)
                for key, v in ans.counters.items():
                    counters.setdefault(key, []).append(v)
    finally:
        gc.enable()
    return SimpleNamespace(seconds=t_end - t_start, times=times, attempted=attempted, failed=failed,
                           completed=attempted - failed, counters=counters, first_error=first_error)


def load_config(entry, override=None):
    config = load_json(ROOT / entry["file"])
    if override:
        config = {**config, **override}
    return config


def prepare(workload: str, device: str, config_override: Optional[dict] = None, bench=None,
            driver: Optional[str] = None):
    """Everything of a cell up to its right-hand sides: the files found by
    name, the kernel library loaded, the hierarchy set up and lowered, with
    the host-clock span of each step (``spans``).  ``driver`` puts another
    driver in the traffic's place (``reference_control``: the control)."""
    cell, entry, e2e, per_layer = find_cell(workload, bench)
    config = load_config(entry, config_override)
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    p = SimpleNamespace(
        cell=cell, e2e=e2e, per_layer=per_layer, config=config, traffic=traffic,
        limits=load_json(BENCH / "limits" / f"{workload}.json"),
        driver=importlib.import_module(f"amgbench.drivers.{driver or traffic['driver']}"),
        reference=importlib.import_module(f"amgbench.reference.{config['reference']}"),
        spans={},
    )
    setup_route = importlib.import_module(f"amgbench.setups.{config['setup']['route']}")

    t = time.perf_counter()
    import torch

    import algebraicmultigrid_tpu_torch as amt

    p.torch, p.amt = torch, amt
    p.dev = torch.device(device)
    p.on_card = p.dev.type == "cuda"
    p.sync = torch.cuda.synchronize if p.on_card else (lambda: None)
    if p.on_card:
        p.dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.init()
    p.spans["imports"] = time.perf_counter() - t

    t = time.perf_counter()
    if p.on_card:
        from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs

        vcycle_legs.load_library()  # built by nvcc into the package's _build/ on a checkout's first run
    p.spans["kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    p.ml = setup_route.build(amt, config["problem"], config["setup"])
    p.spans["hierarchy"] = time.perf_counter() - t

    precision = config["precision"]
    p.dtype, p.coef_dtype = getattr(torch, precision["dtype"]), getattr(torch, precision["coef_dtype"])
    t = time.perf_counter()
    p.h = amt.get_device_hierarchy(p.ml, device=p.dev, dtype=p.dtype, coef_dtype=p.coef_dtype)
    p.sync()
    p.spans["lowering"] = time.perf_counter() - t
    p.dims = tuple(config["problem"]["grid"])
    p.n = math.prod(p.dims)
    return p


def requests_for(p, seed: int):
    """(the right-hand-side pool of ``seed``, the driver's request)."""
    t = time.perf_counter()
    pool = rhs.make_pool(p.traffic["rhs"], p.traffic["pool"], p.n, seed, p.dev)
    request = p.driver.make(p, pool)
    p.sync()
    p.spans["pool"] = time.perf_counter() - t
    return pool, request


def relres_of(p, pool, answers: List[Answer]) -> List[float]:
    """Each answer's relative residual in the reference's float64 operator,
    against the right-hand side it answered."""
    torch = p.torch

    def tensor(v):
        return v if isinstance(v, torch.Tensor) else torch.as_tensor(v, device=p.dev)

    return [p.reference.relres(tensor(a.value), tensor(pool[a.index]), p.dims) for a in answers]


def run(workload: str, seed: int, seconds: float, traced: bool, device: str, t_process: float,
        config_override: Optional[dict] = None, bench=None, driver: Optional[str] = None) -> Dict[str, Any]:
    """One run of a cell; returns the result object (``checks`` last).
    ``driver`` runs another driver in the traffic's place (``prepare``)."""
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    startup = time.perf_counter() - t_process
    p = prepare(workload, device, config_override, bench, driver)
    p.spans = {"startup": startup, **p.spans}
    torch = p.torch
    pool, request = requests_for(p, seed)
    keeper = Keeper(seed, KEPT_ANSWERS)
    t = time.perf_counter()
    warm = [request(k) for k in range(getattr(p.driver, "WARMUP_REQUESTS", WARMUP_REQUESTS))]
    if warm:
        keeper.reserve(warm[-1], torch)
    p.sync()
    p.spans["warmup"] = time.perf_counter() - t
    if p.on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_process
    log("set-up spans (s): " + " ".join(f"{k} {v!r}" for k, v in p.spans.items()) + f"; setup_s {setup_s!r}")

    prof = contextlib.nullcontext()
    if traced:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if p.on_card else []))
    with prof:
        win = run_window(request, seconds, keeper, traced)
        p.sync()
    memory_peak = torch.cuda.max_memory_allocated(p.dev) if p.on_card else 0
    if win.first_error:
        log("first failed request:\n" + win.first_error)
    log(f"window {win.seconds!r} s: {win.attempted} requests, {win.failed} failed")

    metrics = {}
    breakdown = None
    device_info = {
        "platform": "gpu" if p.on_card else "cpu",
        "kind": torch.cuda.get_device_name(p.dev) if p.on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(memory_peak),
    }
    if not traced:
        values = p.driver.end_to_end(win)
        values["setup_s"] = setup_s
        for m in p.e2e:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        t = time.perf_counter()
        tr = trace.from_profile(prof)
        ctx = SimpleNamespace(spans=p.spans, counters=win.counters, trace=tr, hierarchy=p.h, window=win)
        for m in p.per_layer:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            device_info["busy_s"] = trace.busy_s(tr)
            device_info["window_s"] = tr.window_s
            breakdown = {"device_ops": trace.top_ops(tr), "idle_gaps": trace.idle_gaps(tr)}
        log(f"trace read in {time.perf_counter() - t!r} s ({len(tr.ops) if tr else 0} device operations)")
        del tr, ctx
    del prof

    # the program's state goes before the reference runs
    answers = keeper.answers()
    keeper.buffers = None
    del request, warm
    p.h = None
    p.ml._device_cache.clear()
    p.ml = None
    gc.collect()
    if p.on_card:
        torch.cuda.empty_cache()

    relres = relres_of(p, pool, answers)
    readings = {"relres_max": max(relres) if relres else float("inf"), "failed": float(win.failed)}
    checks = {name: {"value": readings[name], "limit": spec["limit"]} for name, spec in p.limits["checks"].items()}
    correct = bool(answers) and win.completed > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    log(f"judged {len(answers)} answers of {win.attempted}: relres {relres}")

    found = sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))
    if found:
        raise SystemExit(f"modules that must not load in the benchmark's process were loaded: {found}")

    result = {"correct": correct, "attempted": win.attempted, "failed": win.failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result
