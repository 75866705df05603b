"""Smoke test of the PyTorch port on one NVIDIA card.

Runs, in order, and exits non-zero on the first failure:

1. checks that a CUDA card is present and prints its name and power limit;
2. builds the fused V-cycle leg kernels (K1 ``fused_down``, K2 ``fused_up``)
   from ``algebraicmultigrid_tpu_torch/csrc/vcycle_legs.cu``;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's level-0 and level-1 shapes of the 4096² problem (max relative
   error <= 1e-5 in float32) and times both with CUDA events;
4. drives the main path once — structured SA setup of
   ``poisson((4096, 4096), lattice=True)`` with box-3 aggregation, lowering to
   the card, ``solve_refined(tol=1e-8)`` — with the kernels' launch counters
   zeroed just before it, and asserts 8 levels, operator complexity 1.225,
   relative residual < 1e-8 within 4 rounds and nonzero launch counts;
5. checks the solve against a direct solve, and one cycle on the card
   against the same cycle on the CPU, on a small 192² problem.

The last two lines of output are the card's ``nvidia-smi`` name/power line
and ``{"ok": true, "device": {...}}``; the line before them lists every
kernel with its launches, error and times.  Run from the repository root:

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
TOL = 1e-8
MAX_ROUNDS = 4
KERNEL_RTOL = 1e-5
TIMED_REPS = 20
SOURCE = "algebraicmultigrid_tpu_torch/csrc/vcycle_legs.cu"
REPLACES = {
    "fused_down": "algebraicmultigrid_tpu/ops/pallas/vcycle_kernels.py:1432",
    "fused_up": "algebraicmultigrid_tpu/ops/pallas/vcycle_kernels.py:1736",
}


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


def compare_kernels(device):
    """Phase 3: each leg kernel against its plain version at the main
    path's L0 and L1 shapes."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    ml = setup(N)
    h = amt.build_device_hierarchy(ml, device=device, dtype=torch.float32)
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = {"fused_down": [], "fused_up": []}
    for lvl in (0, 1):
        L = h.levels[lvl]
        if L.fused is None:
            raise AssertionError(f"level {lvl} has no fused legs")
        n, pad, nc = L.A.shape[0], L.A.rows_padded, L.R.shape[0]

        def vec(m, length):
            v = torch.zeros(length)
            v[:m] = torch.randn(m, generator=gen)
            return v.to(device)

        x, b, xc = vec(n, pad), vec(n, pad), vec(nc, nc)
        for x_zero in (False, True):
            got = vl.fused_down(L.fused, x, b, x_zero=x_zero)
            ref = vl.fused_down_reference(L.fused, x, b, x_zero=x_zero)
            errs = [errors(g, r) for g, r in zip(got, ref)]
            rows["fused_down"].append(dict(
                level=lvl, dims=L.fused.row_dims, x_zero=x_zero,
                max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
                ms=time_ms(lambda: vl.fused_down(L.fused, x, b, x_zero=x_zero)),
                plain_ms=time_ms(lambda: vl.fused_down_reference(L.fused, x, b, x_zero=x_zero)),
            ))
        got = vl.fused_up(L.fused, x, b, xc)
        ref = vl.fused_up_reference(L.fused, x, b, xc)
        abs_err, rel = errors(got, ref)
        rows["fused_up"].append(dict(
            level=lvl, dims=L.fused.row_dims, max_abs_err=abs_err, max_rel_err=rel,
            ms=time_ms(lambda: vl.fused_up(L.fused, x, b, xc)),
            plain_ms=time_ms(lambda: vl.fused_up_reference(L.fused, x, b, xc)),
        ))
    for name, rs in rows.items():
        for r in rs:
            log(f"kernel {name} L{r['level']} {r['dims']}"
                + (f" x_zero={r['x_zero']}" if "x_zero" in r else "")
                + f": max_rel_err {r['max_rel_err']!r} max_abs_err {r['max_abs_err']!r}"
                + f" kernel {r['ms']!r} ms plain {r['plain_ms']!r} ms")
            if not r["max_rel_err"] <= KERNEL_RTOL:
                raise AssertionError(f"{name} disagrees with its plain version: {r}")
    return rows


def main_path(device):
    """Phase 4: setup, lowering and the refined solve at N², once, with the
    launch counters zeroed just before."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import run_fixed_cycles
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    for key in vl.launches:
        vl.launches[key] = 0
    t0 = time.perf_counter()
    ml = setup(N)
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
    counts = dict(vl.launches)

    levels = len(ml.levels) + 1
    oc = ml.operator_complexity()
    relres = float(np.linalg.norm(b - ml.levels[0].A @ x) / np.linalg.norm(b))
    log(f"main path {N}x{N}: levels {levels} operator_complexity {oc!r}")
    log(f"level dims {[L.A.row_dims for L in h.levels]} fused {[L.fused is not None for L in h.levels]}")
    log(f"setup_s {t1 - t0!r} lowering_s {t2 - t1!r} solve_s {t3 - t2!r}")
    log(f"refine rounds {len(hist) - 1} pcg_iters_per_round {stats['inner_iters']} history {hist}")
    log(f"solve_relres {relres!r}")
    log(f"launches in the main path {counts}")

    xv = torch.zeros(h.fine_padded, device=device)
    bv = torch.zeros(h.fine_padded, device=device)
    bv[: N * N] = torch.as_tensor(b, dtype=torch.float32, device=device)
    vcycle_ms = time_ms(lambda: run_fixed_cycles(h, xv, bv, 1), reps=10)
    h_plain = amt.build_device_hierarchy(ml, device=device, dtype=torch.float32, fused=False)
    plain_vcycle_ms = time_ms(lambda: run_fixed_cycles(h_plain, xv, bv, 1), reps=10)
    del h_plain
    log(f"vcycle_ms fused {vcycle_ms!r} plain {plain_vcycle_ms!r}")

    if not (x.shape == (N * N,) and np.isfinite(x).all()):
        raise AssertionError("solution is not a finite vector of the problem's size")
    if levels != EXPECT_LEVELS:
        raise AssertionError(f"levels {levels} != {EXPECT_LEVELS}")
    if round(oc, 3) != EXPECT_OC:
        raise AssertionError(f"operator complexity {oc} != {EXPECT_OC}")
    if not relres < TOL:
        raise AssertionError(f"solve_relres {relres} >= {TOL} after {len(hist) - 1} rounds")
    if not all(counts[k] > 0 for k in ("down", "up")):
        raise AssertionError(f"the main path did not launch every kernel: {counts}")
    return counts


def small_reference(device):
    """Phase 5: at SMALL², the card's solve against a direct solve, and one
    float64 cycle on the card against the same cycle on the CPU."""
    import scipy.sparse.linalg as spla
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration

    # a smaller proxy keeps the structured fast path (every level a lattice)
    ml = setup(SMALL, proxy=64, cut_rows=2000, min_proxy_dim=16)
    n = SMALL * SMALL
    b = np.random.default_rng(1).standard_normal(n)
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
    cyc_err = float(np.abs(cyc[device] - cyc["cpu"]).max() / np.abs(cyc["cpu"]).max())
    log(f"small {SMALL}x{SMALL}: solve vs direct rel err {err!r}; f64 cycle card vs cpu rel err {cyc_err!r}")
    if not err < 1e-6:
        raise AssertionError(f"solve disagrees with the direct solve: {err}")
    if not cyc_err < 1e-12:
        raise AssertionError(f"cycle on the card disagrees with the CPU: {cyc_err}")


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

    rows = compare_kernels(device)
    torch.cuda.empty_cache()
    counts = main_path(device)
    torch.cuda.empty_cache()
    small_reference(device)

    kernels = []
    for name, key in (("fused_down", "down"), ("fused_up", "up")):
        l0 = [r for r in rows[name] if r["level"] == 0 and not r.get("x_zero", False)][0]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=counts[key], max_abs_err=max(r["max_abs_err"] for r in rows[name]),
            ms=l0["ms"], plain_ms=l0["plain_ms"],
        ))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
