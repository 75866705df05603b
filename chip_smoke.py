"""Smoke test of the PyTorch port on one NVIDIA card.

Runs, in order, and exits non-zero on the first failure:

1. checks that a CUDA card is present and prints its name and power limit;
2. builds the port's CUDA library (``csrc/vcycle_legs.cu`` with K1
   ``fused_down``, K2 ``fused_up``, K3 ``fused_updown``, and
   ``csrc/tail_kernel.cu`` with K4 ``fused_tail``) in one ``nvcc`` call;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes of the 4096² problem — K1/K2/K3 at level 0 (4096²)
   and level 1 (1366²), K4 on the tail (456² … 6² plus the 2×2 coarse
   solve), ``x_zero`` both ways where the kernel takes it — to max relative
   error <= 1e-5 in float32, and times kernel, plain version and the same
   work through the K1/K2 legs with CUDA events;
4. drives the main path once — structured SA setup of
   ``poisson((4096, 4096), lattice=True)`` with box-3 aggregation, lowering to
   the card, ``solve_refined(tol=1e-8)`` — with the launch counters zeroed
   just before it, and asserts 8 levels, operator complexity 1.225,
   relative residual < 1e-8 within 4 rounds and launches of K1, K2 and K4;
5. runs ``run_fixed_cycles`` (the updown loop) for 400 cycles from x = 0 on
   ``bench.py``'s right-hand side A·1, with the counters zeroed just
   before: ms per cycle, relative residual after the cycles (< 1e-5) and
   exactly updown 399, tail 400, down 401, up 401 launches; and holds 3
   fixed cycles against 3 iterated cycles (float32 in the 2-norm to 1e-5,
   float64 to 1e-10);
6. checks the solve against a direct solve, and one cycle on the card
   against the same cycle on the CPU, on a small 192² problem whose whole
   hierarchy is the tail (asserts that K4 ran).

The last two lines of output are the card's ``nvidia-smi`` name/power line
and ``{"ok": true, "device": {...}}``; the line before them lists every
kernel with its launches, error, times and bound.  Run from the repository
root:

    python3 chip_smoke.py
"""

import json
import subprocess
import sys
import time

import numpy as np

N = 4096
SMALL = 192
BOX = 3
EXPECT_LEVELS = 8
EXPECT_OC = 1.225
EXPECT_TAIL_START = 2  # as in the JAX package: the first level under 250k rows
TOL = 1e-8
MAX_ROUNDS = 4
KERNEL_RTOL = 1e-5
TIMED_REPS = 20
CYCLES = 400
CYCLES_RELRES = 1e-5
# 3 fixed cycles against 3 iterated cycles from x = 0 on b = A·1.  The two
# differ by the deduped boundary step of the double sweep, exact at
# omega = 1 but rounded differently; the difference is rounding noise that
# the cycles carry to every cell, so float32 is held in the 2-norm
# (‖x_fixed − x_iter‖ / ‖x_iter‖; the max-abs form read 1.4e-5 on an H100 at
# 4096², the plain versions on the CPU 1.7e-6 at 1800²) and float64 in the
# max-abs form.
FIXED_RTOL = {"float32": KERNEL_RTOL, "float64": 1e-10}
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
SOURCES = {
    "fused_down": "algebraicmultigrid_tpu_torch/csrc/vcycle_legs.cu",
    "fused_up": "algebraicmultigrid_tpu_torch/csrc/vcycle_legs.cu",
    "fused_updown": "algebraicmultigrid_tpu_torch/csrc/vcycle_legs.cu",
    "fused_tail": "algebraicmultigrid_tpu_torch/csrc/tail_kernel.cu",
}
REPLACES = {
    "fused_down": "algebraicmultigrid_tpu/ops/pallas/vcycle_kernels.py:1432",
    "fused_up": "algebraicmultigrid_tpu/ops/pallas/vcycle_kernels.py:1736",
    "fused_updown": "algebraicmultigrid_tpu/ops/pallas/vcycle_kernels.py:2222",
    "fused_tail": "algebraicmultigrid_tpu/ops/pallas/tail_kernel.py:451",
}
COUNTER = {"fused_down": "down", "fused_up": "up", "fused_updown": "updown", "fused_tail": "tail"}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=TIMED_REPS):
    """Mean milliseconds per call on the card, by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def setup(n, **kwargs):
    import algebraicmultigrid_tpu_torch as amt

    return amt.structured_smoothed_aggregation(
        amt.poisson((n, n), lattice=True), aggregate=amt.StructuredAggregation(box=BOX), **kwargs
    )


def errors(got, ref):
    """(max abs, max relative) error of a kernel output against its plain
    version; raises on a non-finite output."""
    import torch

    got, ref = got.double().cpu(), ref.double().cpu()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output is not finite")
    diff = float((got - ref).abs().max())
    return diff, diff / max(float(ref.abs().max()), 1e-300)


# --------------------------------------------------------------------------
# bounds: bytes each input read once and each output written once, and the
# flops the passes do on these shapes
# --------------------------------------------------------------------------


def _color_cells(leg):
    """Cells of each color on the level's periodic coloring."""
    grid = np.asarray(leg.color_grid)
    a, b = grid.shape
    Wx, Wy = leg.row_dims
    nx = np.array([len(range(u, Wx, a)) for u in range(a)])
    ny = np.array([len(range(v, Wy, b)) for v in range(b)])
    cells = {}
    for u in range(a):
        for v in range(b):
            cells[int(grid[u, v])] = cells.get(int(grid[u, v]), 0) + int(nx[u] * ny[v])
    return cells


def leg_work(leg, steps, correct, restrict, x_zero=False):
    """(words moved, flops) of one leg's passes on one level: the A planes,
    dinv, T, S and b read, x written, and x read unless it starts at zero;
    x_c read for a correction, b_c written for a restriction."""
    Wx, Wy = leg.row_dims
    n = Wx * Wy
    nc = leg.col_dims[0] * leg.col_dims[1]
    nA = len(leg.offsA)
    cells = _color_cells(leg)
    words = (nA + 3) * n + 2 * n
    flops = sum(cells.get(c, 0) * (2 * nA + 3) for c in steps)
    if not x_zero:
        words += n
    if correct:
        words += nc
        flops += n * (3 * nA + 4)  # T·x_c at each neighbour, the stencil, S
    if restrict:
        words += nc
        flops += n * (2 * nA + 2) + n * (2 * nA + 3) + n  # residual and g, terms, box sums
    return words, flops


def bound(words, flops, itemsize):
    """(bound_ms, bound_by) on the H100's published peaks."""
    t_bytes = words * itemsize / HBM_BYTES_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tail_work(tail, x_zero):
    """(words, flops) of one whole-tail cycle: every level's planes and Mc
    read once, the entry level's b (and x unless zero) read and x written;
    the coarser levels' vectors never leave the kernel's work buffer."""
    n0 = tail.levels[0].row_dims[0] * tail.levels[0].row_dims[1]
    words = tail.Mc.numel() + (2 if x_zero else 3) * n0
    flops = 2 * tail.Mc.numel()
    for leg in tail.levels:
        words += (len(leg.offsA) + 3) * leg.row_dims[0] * leg.row_dims[1]
        flops += leg_work(leg, leg.steps, False, True)[1] + leg_work(leg, leg.steps, True, False)[1]
    return words, flops


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def compare_kernels(device, ml):
    """Phase 3: every kernel against its plain version at the main path's
    shapes, with kernel, plain and K1/K2-route times."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _cycle
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    h = amt.build_device_hierarchy(ml, device=device, dtype=torch.float32)
    if h.tail is None or h.tail_start != EXPECT_TAIL_START:
        raise AssertionError(f"the tail starts at {h.tail_start}, not at level {EXPECT_TAIL_START}")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def vec(m, length):
        v = torch.zeros(length)
        v[:m] = torch.randn(m, generator=gen)
        return v.to(device)

    rows = {name: [] for name in SOURCES}

    def record(name, got, ref, fn, plain, work, **extra):
        errs = [errors(g, r) for g, r in zip(got, ref)]
        rows[name].append(dict(
            extra, max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
            ms=time_ms(fn), plain_ms=time_ms(plain), work=work,
        ))

    for lvl in (0, 1):
        L = h.levels[lvl]
        f = L.fused
        if f is None:
            raise AssertionError(f"level {lvl} has no fused legs")
        n, pad, nc = L.A.shape[0], L.A.rows_padded, L.R.shape[0]
        x, b, xc = vec(n, pad), vec(n, pad), vec(nc, nc)
        for x_zero in (False, True):
            record(
                "fused_down", vl.fused_down(f, x, b, x_zero=x_zero),
                vl.fused_down_reference(f, x, b, x_zero=x_zero),
                lambda: vl.fused_down(f, x, b, x_zero=x_zero),
                lambda: vl.fused_down_reference(f, x, b, x_zero=x_zero),
                leg_work(f, f.steps, False, True, x_zero=x_zero),
                level=lvl, dims=f.row_dims, x_zero=x_zero,
            )
        record(
            "fused_up", [vl.fused_up(f, x, b, xc)], [vl.fused_up_reference(f, x, b, xc)],
            lambda: vl.fused_up(f, x, b, xc), lambda: vl.fused_up_reference(f, x, b, xc),
            leg_work(f, f.steps, True, False), level=lvl, dims=f.row_dims,
        )
        record(
            "fused_updown", vl.fused_updown(f, x, b, xc), vl.fused_updown_reference(f, x, b, xc),
            lambda: vl.fused_updown(f, x, b, xc), lambda: vl.fused_updown_reference(f, x, b, xc),
            leg_work(f, f.steps2, True, True), level=lvl, dims=f.row_dims,
        )
        rows["fused_updown"][-1]["legs_ms"] = time_ms(
            lambda: vl.fused_down(f, vl.fused_up(f, x, b, xc), b)
        )

    # K4 against the same work through the K1/K2 legs on every tail level
    h_legs = amt.build_device_hierarchy(ml, device=device, dtype=torch.float32, tail=False)
    lvl = h.tail_start
    L = h.levels[lvl]
    n, pad = L.A.shape[0], L.A.rows_padded
    x, b = vec(n, pad), vec(n, pad)
    for x_zero in (False, True):
        xin = torch.zeros_like(x) if x_zero else x
        record(
            "fused_tail", [tk.fused_tail(h.tail, xin, b, x_zero=x_zero)],
            [tk.fused_tail_reference(h.tail, xin, b, x_zero=x_zero)],
            lambda: tk.fused_tail(h.tail, xin, b, x_zero=x_zero),
            lambda: tk.fused_tail_reference(h.tail, xin, b, x_zero=x_zero),
            tail_work(h.tail, x_zero), level=lvl, dims=h.tail.levels[0].row_dims, x_zero=x_zero,
        )
        rows["fused_tail"][-1]["legs_ms"] = time_ms(
            lambda: _cycle(h_legs, amt.V(), xin, b, lvl, x_zero=x_zero)
        )
    del h_legs

    for name, rs in rows.items():
        for r in rs:
            r["bound_ms"], r["bound_by"] = bound(*r.pop("work"), 4)
            log(f"kernel {name} L{r['level']} {r['dims']}"
                + (f" x_zero={r['x_zero']}" if "x_zero" in r else "")
                + f": max_rel_err {r['max_rel_err']!r} max_abs_err {r['max_abs_err']!r}"
                + f" kernel {r['ms']!r} ms plain {r['plain_ms']!r} ms"
                + (f" legs {r['legs_ms']!r} ms" if "legs_ms" in r else "")
                + f" bound {r['bound_ms']!r} ms ({r['bound_by']})")
            if not r["max_rel_err"] <= KERNEL_RTOL:
                raise AssertionError(f"{name} disagrees with its plain version: {r}")
    return rows


def zero_counts():
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    for key in vl.launches:
        vl.launches[key] = 0


def read_counts():
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    return dict(vl.launches)


def main_path(device, ml, setup_s):
    """Phase 4: lowering and the refined solve at N², once, with the launch
    counters zeroed just before."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration

    zero_counts()
    t1 = time.perf_counter()
    h = amt.get_device_hierarchy(ml, device=device, dtype=torch.float32)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    b = np.random.default_rng(0).standard_normal(N * N)
    stats = {}
    x, hist = amt.solve_refined(
        ml, b, tol=TOL, max_rounds=MAX_ROUNDS, device=device, log=True, stats=stats
    )
    t3 = time.perf_counter()
    counts = read_counts()

    levels = len(ml.levels) + 1
    oc = ml.operator_complexity()
    relres = float(np.linalg.norm(b - ml.levels[0].A @ x) / np.linalg.norm(b))
    log(f"main path {N}x{N}: levels {levels} operator_complexity {oc!r}")
    log(f"level dims {[L.A.row_dims for L in h.levels]} fused {[L.fused is not None for L in h.levels]}"
        f" tail_start {h.tail_start}")
    log(f"setup_s {setup_s!r} lowering_s {t2 - t1!r} solve_s {t3 - t2!r}")
    log(f"refine rounds {len(hist) - 1} pcg_iters_per_round {stats['inner_iters']} history {hist}")
    log(f"solve_relres {relres!r}")
    log(f"launches in the solve {counts}")

    bv = torch.zeros(h.fine_padded, device=device)
    bv[: N * N] = torch.as_tensor(b, dtype=torch.float32, device=device)
    xv = torch.zeros_like(bv)
    vcycle_ms = time_ms(lambda: _one_iteration(h, amt.V(), xv, bv), reps=10)
    h_plain = amt.build_device_hierarchy(ml, device=device, dtype=torch.float32, fused=False, tail=False)
    plain_vcycle_ms = time_ms(lambda: _one_iteration(h_plain, amt.V(), xv, bv), reps=10)
    del h_plain
    log(f"vcycle_ms kernels {vcycle_ms!r} plain {plain_vcycle_ms!r}")

    if not (x.shape == (N * N,) and np.isfinite(x).all()):
        raise AssertionError("solution is not a finite vector of the problem's size")
    if levels != EXPECT_LEVELS:
        raise AssertionError(f"levels {levels} != {EXPECT_LEVELS}")
    if round(oc, 3) != EXPECT_OC:
        raise AssertionError(f"operator complexity {oc} != {EXPECT_OC}")
    if not relres < TOL:
        raise AssertionError(f"solve_relres {relres} >= {TOL} after {len(hist) - 1} rounds")
    if not all(counts[k] > 0 for k in ("down", "up", "tail")):
        raise AssertionError(f"the solve did not launch every kernel of its path: {counts}")
    return h, counts


def fixed_cycles(device, ml, h):
    """Phase 5: the updown loop at N² from x = 0 on bench.py's right-hand
    side b = A·1, with the launch counters zeroed just before; then 3 fixed
    cycles against 3 iterated cycles."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, run_fixed_cycles

    b = ml.levels[0].A @ np.ones(N * N)
    bv = torch.zeros(h.fine_padded, device=device)
    bv[: N * N] = torch.as_tensor(b, dtype=torch.float32, device=device)
    xv = torch.zeros_like(bv)
    torch.cuda.synchronize()
    zero_counts()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    x = run_fixed_cycles(h, xv, bv, CYCLES)
    stop.record()
    torch.cuda.synchronize()
    counts = read_counts()
    ms_per_cycle = start.elapsed_time(stop) / CYCLES
    xh = x[: N * N].double().cpu().numpy()
    relres = float(np.linalg.norm(b - ml.levels[0].A @ xh) / np.linalg.norm(b))
    log(f"fixed cycles {CYCLES}: ms_per_cycle {ms_per_cycle!r} relres_after_cycles {relres!r}")
    log(f"launches in the fixed cycles {counts}")

    fixed_rel = {}
    h64 = amt.build_device_hierarchy(ml, device=device, dtype=torch.float64)
    for hh in (h, h64):
        bb = bv.to(hh.levels[0].A.data.dtype)
        x_fixed = run_fixed_cycles(hh, torch.zeros_like(bb), bb, 3)
        x_it = torch.zeros_like(bb)
        for _ in range(3):
            x_it = _one_iteration(hh, amt.V(), x_it, bb)
        key = str(bb.dtype).removeprefix("torch.")
        norm_rel = float((x_fixed.double() - x_it.double()).norm() / x_it.double().norm())
        fixed_rel[key] = norm_rel if key == "float32" else errors(x_fixed, x_it)[1]
        log(f"3 fixed cycles vs 3 iterated cycles, {key}: max_rel_err {errors(x_fixed, x_it)[1]!r}"
            f" norm_rel_err {norm_rel!r}")
    del h64

    if not np.isfinite(xh).all() or not relres < CYCLES_RELRES:
        raise AssertionError(f"relres_after_cycles {relres} >= {CYCLES_RELRES}")
    want = {"updown": CYCLES - 1, "tail": CYCLES, "down": CYCLES + 1, "up": CYCLES + 1}
    if counts != want:
        raise AssertionError(f"fixed-cycle launches {counts} != {want}")
    if not all(fixed_rel[k] <= tol for k, tol in FIXED_RTOL.items()):
        raise AssertionError(f"fixed cycles disagree with iterated cycles: {fixed_rel}")
    return counts, ms_per_cycle


def small_reference(device):
    """Phase 6: at SMALL², the card's solve against a direct solve, and one
    float64 cycle on the card against the same cycle on the CPU; the whole
    hierarchy is the tail there, so the card's cycle must run K4."""
    import scipy.sparse.linalg as spla
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration

    # a smaller proxy keeps the structured fast path (every level a lattice)
    ml = setup(SMALL, proxy=64, cut_rows=2000, min_proxy_dim=16)
    n = SMALL * SMALL
    b = np.random.default_rng(1).standard_normal(n)
    zero_counts()
    x = amt.solve_refined(ml, b, tol=1e-10, device=device)
    x_direct = spla.spsolve(ml.levels[0].A.tocsr().tocsc(), b)
    err = float(np.abs(x - x_direct).max() / np.abs(x_direct).max())
    cyc = {}
    for dev in (device, "cpu"):
        h = amt.build_device_hierarchy(ml, device=dev, dtype=torch.float64)
        bp = torch.zeros(h.fine_padded, dtype=torch.float64)
        bp[:n] = torch.as_tensor(b)
        bp = bp.to(dev)
        cyc[dev] = _one_iteration(h, amt.V(), torch.zeros_like(bp), bp).cpu().numpy()
    counts = read_counts()
    cyc_err = float(np.abs(cyc[device] - cyc["cpu"]).max() / np.abs(cyc["cpu"]).max())
    log(f"small {SMALL}x{SMALL}: solve vs direct rel err {err!r}; f64 cycle card vs cpu rel err {cyc_err!r};"
        f" launches {counts}")
    if not err < 1e-6:
        raise AssertionError(f"solve disagrees with the direct solve: {err}")
    if not cyc_err < 1e-12:
        raise AssertionError(f"cycle on the card disagrees with the CPU: {cyc_err}")
    if not counts["tail"] > 0:
        raise AssertionError(f"the small problem did not run the tail kernel: {counts}")


def main():
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: chip_smoke needs one")
        return 1
    device = "cuda"
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    t = time.perf_counter()
    vl.load_library()
    log(f"kernels built and loaded in {time.perf_counter() - t!r} s: {vl.library_path().name}")

    t = time.perf_counter()
    ml = setup(N)
    setup_s = time.perf_counter() - t
    rows = compare_kernels(device, ml)
    torch.cuda.empty_cache()
    h, solve_counts = main_path(device, ml, setup_s)
    cycle_counts, _ = fixed_cycles(device, ml, h)
    del h
    torch.cuda.empty_cache()
    small_reference(device)

    kernels = []
    for name, rs in rows.items():
        first = rs[0]  # L0 (the tail's entry level for K4), x read from its input
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=cycle_counts[COUNTER[name]], launches_solve=solve_counts[COUNTER[name]],
            max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=None,
        ))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
