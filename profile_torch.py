"""Where a cycle's device time goes, on one NVIDIA card.

Sets up the 4096² flagship (structured SA, box-3), lowers it to the card in
float32 and, after a warm-up, profiles with ``torch.profiler``:

* ``fixed``: ``run_fixed_cycles`` over 20 cycles (K3 at L0, L1 legs, K4);
* ``vcycle``: 20 V-cycles through ``_one_iteration`` (the solve's
  preconditioner: L0 and L1 legs, K4).

With the argument ``unstructured`` it profiles instead 20 V-cycles of
``bench.py``'s scrambled Poisson 1024² (``smoothed_aggregation`` with
defaults: BSG levels with K6, natural-order GS levels with ``scan_gs``);
with ``3d``, 20 V-cycles of ``poisson((256, 256, 256), lattice=True)``
through ``structured_smoothed_aggregation_nd(proxy=47, cut_rows=20000)``
(K7 at L0, masked 8-color sweeps and K6 below); with ``fwdbwd``, 20
V-cycles of the 4096² flagship with forward/backward GS (K5 on every
Lat2D level, no legs, no tail); with ``subcycle``, the flagship's ``fixed``
and ``vcycle`` runs on the hierarchy built with ``subcycle=True`` (K9 in
place of the L1 legs and K4); with ``f64bf16``, the same runs in float64
with bf16 coefficient planes (``bench.py``'s ``AMG_BENCH_DTYPE=float64``
under its default ``AMG_COEF_DTYPE=bfloat16``: K1–K4's ``f64_bf16``
entries); with ``rs``, 20 V-cycles of ``bench.py``'s
``AMG_BENCH_METHOD=rs`` at 4096² (``ruge_stuben`` with ``StructuredRS``
and multicolor GS: K5 on the Lat2D levels, masked sweeps and K6 on the
others); with ``nosym``, the flagship's ``fixed`` and ``vcycle`` runs set up
with ``symmetry=NoSymmetry()`` and bf16 planes (no factored stash: the
non-factored K1/K2 at L0, L1 and the non-factored K4; the fixed-cycle loop
iterates V-cycles, since K3 takes factored levels only).

For each it prints the ms per cycle by CUDA events, the device time of each
kernel and its share, the device's idle share of the window (1 − the
summed kernel time over the window's elapsed time; the kernel rows only
(``kernel_rows``): the cycle's ``record_function`` ranges carry the device
time of the kernels inside them, and so do the CPU operators that launch
them) and the port's kernel launches per cycle.  Run from the repository root:

    python3 profile_torch.py [unstructured | 3d | fwdbwd | subcycle | f64bf16 | rs | nosym]
"""

import functools
import subprocess
import sys

import numpy as np

N = 4096
NU = 1024
CYCLES = 20


def lattice_runs(amt, torch, subcycle=False, dtype="float32", coef_dtype=None, nosym=False):
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, run_fixed_cycles

    ml = amt.structured_smoothed_aggregation(
        amt.poisson((N, N), lattice=True), aggregate=amt.StructuredAggregation(box=3),
        **(dict(symmetry=amt.NoSymmetry()) if nosym else {}),
    )
    dtype = getattr(torch, dtype)
    h = amt.build_device_hierarchy(ml, device="cuda", dtype=dtype, subcycle=subcycle, coef_dtype=coef_dtype)
    if subcycle and h.sub is None:
        raise SystemExit("the flagship built no subcycle cache")
    b = torch.zeros(h.fine_padded, dtype=dtype, device="cuda")
    b[: N * N] = torch.as_tensor(ml.levels[0].A @ np.ones(N * N), dtype=dtype, device="cuda")

    def fixed():
        run_fixed_cycles(h, torch.zeros_like(b), b, CYCLES)

    def vcycles():
        x = torch.zeros_like(b)
        for _ in range(CYCLES):
            x = _one_iteration(h, amt.V(), x, b)

    return (("fixed", fixed), ("vcycle", vcycles))


def unstructured_runs(amt, torch):
    import scipy.sparse as sp

    from algebraicmultigrid_tpu_torch.models.device import _enter_basis, _one_iteration

    A = sp.csr_matrix(amt.poisson((NU, NU)))
    p = np.random.default_rng(1).permutation(A.shape[0])
    Ap = A[p][:, p].tocsr()
    ml = amt.smoothed_aggregation(Ap)
    h = amt.build_device_hierarchy(ml, device="cuda", dtype=torch.float32)
    b = torch.zeros(h.fine_padded, device="cuda")
    b[: NU * NU] = torch.as_tensor(Ap @ np.ones(NU * NU), dtype=torch.float32, device="cuda")
    b = _enter_basis(h, b)

    def vcycles():
        x = torch.zeros_like(b)
        for _ in range(CYCLES):
            x = _one_iteration(h, amt.V(), x, b)

    return (("unstructured_vcycle", vcycles),)


def vcycle_runs(name, ml, h, amt, torch):
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration

    n = ml.levels[0].A.shape[0]
    b = torch.zeros(h.fine_padded, device="cuda")
    b[:n] = torch.as_tensor(ml.levels[0].A @ np.ones(n), dtype=torch.float32, device="cuda")

    def vcycles():
        x = torch.zeros_like(b)
        for _ in range(CYCLES):
            x = _one_iteration(h, amt.V(), x, b)

    return ((name, vcycles),)


def lattice_3d_runs(amt, torch):
    ml = amt.structured_smoothed_aggregation_nd(
        amt.poisson((256, 256, 256), lattice=True), proxy=47, cut_rows=20000
    )
    h = amt.build_device_hierarchy(ml, device="cuda", dtype=torch.float32)
    return vcycle_runs("vcycle_3d", ml, h, amt, torch)


def fwd_bwd_runs(amt, torch):
    ml = amt.structured_smoothed_aggregation(
        amt.poisson((N, N), lattice=True), aggregate=amt.StructuredAggregation(box=3),
        presmoother=amt.GaussSeidel(ordering="multicolor", sweep=amt.ForwardSweep()),
        postsmoother=amt.GaussSeidel(ordering="multicolor", sweep=amt.BackwardSweep()),
    )
    h = amt.build_device_hierarchy(ml, device="cuda", dtype=torch.float32)
    return vcycle_runs("vcycle_fwdbwd", ml, h, amt, torch)


def rs_runs(amt, torch):
    gs = amt.GaussSeidel(ordering="multicolor")
    ml = amt.ruge_stuben(amt.poisson((N, N), lattice=True), CF=amt.StructuredRS(), presmoother=gs, postsmoother=gs)
    h = amt.build_device_hierarchy(ml, device="cuda", dtype=torch.float32)
    return vcycle_runs("vcycle_rs", ml, h, amt, torch)


RUNS = {
    "unstructured": unstructured_runs, "3d": lattice_3d_runs, "fwdbwd": fwd_bwd_runs,
    "subcycle": functools.partial(lattice_runs, subcycle=True),
    "f64bf16": functools.partial(lattice_runs, dtype="float64", coef_dtype="bfloat16"),
    "rs": rs_runs,
    "nosym": functools.partial(lattice_runs, coef_dtype="bfloat16", nosym=True),
}


def kernel_rows(events):
    """(ms, count, key) of each device kernel among a profile's
    ``key_averages()`` rows with device time: rows on a device, not the
    CPU, that are not ``record_function`` ranges (a range's device-side
    row, a user annotation, also named by a CPU row, spans the kernels
    inside it), so that their times add up to the device's busy time."""
    ranges = {e.key for e in events if e.device_type.name == "CPU"}
    rows = []
    for e in events:
        if e.device_type.name == "CPU" or getattr(e, "is_user_annotation", False) or e.key in ranges:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    return rows


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    if not torch.cuda.is_available():
        print("no CUDA card: profile_torch needs one")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")

    runs = RUNS.get(sys.argv[1] if sys.argv[1:] else "", lattice_runs)(amt, torch)
    for name, fn in runs:
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        before = dict(vl.launches)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
        window_ms = start.elapsed_time(stop)
        per_cycle = {k: (vl.launches[k] - before[k]) / CYCLES for k in before if vl.launches[k] != before[k]}
        rows = kernel_rows(prof.key_averages())
        busy = sum(r[0] for r in rows)
        print(f"{name}: {window_ms / CYCLES!r} ms per cycle; device busy {busy / CYCLES!r} ms per cycle;"
              f" idle share {1 - busy / window_ms!r}; kernel launches per cycle {per_cycle}")
        for ms, count, key in sorted(rows, reverse=True):
            print(f"  {ms / CYCLES:9.4f} ms/cycle {100 * ms / busy:6.2f}%  x{count // CYCLES:<4d} {key[:90]}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
