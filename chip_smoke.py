"""Smoke test of the PyTorch port on one NVIDIA card.

Runs, in order, and exits non-zero on the first failure:

1. checks that a CUDA card is present and prints its name and power limit;
2. builds the port's CUDA library from the sources in the checkout
   (``csrc/vcycle_legs.cu`` with K1 ``fused_down``, K2 ``fused_up``, K3
   ``fused_updown``, each with float32 or float64 planes or bf16 planes
   under either, and the non-factored K1/K2 entries; ``csrc/tail_kernel.cu``
   with K4 ``fused_tail`` and ``csrc/tail_nf_kernel.cu`` with its
   non-factored entry;
   ``csrc/subcycle_kernel.cu`` with K9 ``fused_subcycle``;
   ``csrc/bsg_spmv.cu`` with K6; ``csrc/scan_gs.cu``; ``csrc/gs_sweep.cu``
   with K5's march and ``csrc/sweep3d.cu`` with K7's, each with its first
   design, the halo-tile kernel, for comparison; and
   ``csrc/halo_stencil.cu`` with K8), one ``nvcc`` per source, all
   started together, then one link;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes of the 4096² problem — K1/K2/K3 at level 0 (4096²)
   and level 1 (1366²), K4 on the tail (456² … 6² plus the 2×2 coarse
   solve), ``x_zero`` both ways where the kernel takes it — to max relative
   error <= 1e-5 in float32, and times kernel, plain version and the same
   work through the K1/K2 legs with CUDA events; asserts K1/K2 tiled at L0
   and L1 as their plans say and times them in turns (tiled, pass, pass,
   tiled) against the same legs pass by pass; the tiled K1–K4 beside the
   times of the per-pass designs they replaced;
4. drives the main path once — structured SA setup of
   ``poisson((4096, 4096), lattice=True)`` with box-3 aggregation, lowering to
   the card, ``solve_refined(tol=1e-8)`` — with the launch counters zeroed
   just before it, and asserts 8 levels, operator complexity 1.225,
   relative residual < 1e-8 within 4 rounds, launches of K1, K2 and K4,
   and K1/K2 tiled at L0 and L1;
5. runs ``run_fixed_cycles`` (the updown loop) for 400 cycles from x = 0 on
   ``bench.py``'s right-hand side A·1, with the counters zeroed just
   before: ms per cycle, relative residual after the cycles (< 1e-5),
   exactly updown 399, tail 400, down 401, up 401 launches, the leg
   launches by level (K1/K2 once at L0, 400 times at L1) and K3's 399 by
   route (in tiles: the staged route takes bf16 planes only); and holds 3
   fixed cycles against 3 iterated cycles (float32 in the 2-norm to 1e-5,
   float64 to 1e-10);
6. checks the solve against a direct solve, and one cycle on the card
   against the same cycle on the CPU, on a small 192² problem whose whole
   hierarchy is the tail (asserts that K4 ran);
7. sets up the unstructured problem of ``bench.py``: ``poisson((1024,
   1024))`` as a scipy CSR with rows and columns in the order of
   ``np.random.default_rng(1).permutation``, then ``smoothed_aggregation``
   with defaults, lowered to the card in float32; asserts 5 levels plus a
   1×1 coarse solve, BSG on L0–L2 with the fine level in the RCM basis,
   ELL with natural-order GS on L3/L4, and the BSG levels' color counts
   2/9/10, each equal to the greedy coloring of its RCM-permuted matrix;
8. holds K6 ``bsg_spmv`` against its plain version at the L0/L1/L2 shapes
   (max relative error <= 1e-5), timing kernel, plain version and the
   cuSPARSE SpMV of the same permuted CSR (``torch.sparse_csr_tensor``),
   and the natural-order sweep ``scan_gs`` against its plain version on
   L3 and L4, timed in turns on its planned route (the level staged in
   shared memory) and its streamed route;
9. drives the unstructured solve with the counters zeroed just before:
   ``cg_device(tol=1e-6)`` and ``solve_refined(tol=1e-8)`` (its float64
   outer residual an ELL SpMV on the card), each residual checked in the caller's ordering with a scipy
   float64 SpMV; then one V-cycle, whose K6 and ``scan_gs`` launches must
   equal the count derived from the hierarchy, and its time;
10. sets up the 3-D problem of ``bench.py``'s opt-in cell at 256³:
    ``structured_smoothed_aggregation_nd(poisson((256, 256, 256),
    lattice=True), proxy=47, cut_rows=20000)``, and asserts what the JAX
    package gives: 5 levels of 16,777,216 / 636,056 / 24,389 / 1,000 / 64
    rows + an 8-row QR, operator complexity 1.14878, L0 a LatND with 7
    offsets, 2 colors and the K7 cache (steps 0, 1, 0), L1–L4 lowered as the
    JAX package lowers them (SDIA A; P BSG/BSG/Dense/SDIA; R
    ELL/ELL/Dense/SDIA); asserts that L0's K7 has a march plan, holds K7
    against its plain version at L0 and on a 13×9×100 grid in float32 and
    float64 (max relative error <= 1e-5 and 1e-12), the march and the
    halo-tile kernel it replaced, and times the two in turns at L0; runs ``cg_device(tol=1e-6)`` and ``solve_refined(tol=1e-8)`` with
    the counters zeroed just before, each residual checked with a float64
    LatND SpMV on the card; then one V-cycle, with exactly 2 K7 launches
    and the K6 launches derived from the hierarchy, and its time;
11. sets up the 4096² flagship with forward-GS presmoothing and
    backward-GS postsmoothing, which has no legs and no tail: asserts 8
    levels and K5 on every Lat2D level, each on its planned route (the
    march on the level as the grid (Wx, 1, Wy), ``plan_march``); holds K5's
    march and the halo-tile kernel it replaced (K5's first design) against
    the plain version and times the two in turns at every Lat2D level (L0
    4096² … L6 6²; back-to-back calls, so L2…L6 time the launch path as
    well), runs ``solve_refined(tol=1e-8)`` with the counters zeroed just
    before, and counts one V-cycle: exactly 14 K5 launches (2 on every
    Lat2D level) and none of K1–K4, and times it by CUDA events;
12. lowers the 4096² flagship of phase 4 with ``subcycle=True`` and asserts
    ``sub_start`` 1 and ``tail_start`` 2, as the JAX package gives them;
    holds K9 ``fused_subcycle`` against its plain version at L1 (1366²) in
    float32 and float64 (max relative error <= 1e-5 and 1e-12), and at L1
    (64²) of the 192² problem with the tail limited to 600 rows; times K9,
    its plain version, the route it replaces (L1 ``fused_down`` + K4 + L1
    ``fused_up``) and K4 entered at L1 (``tail_max_rows=2_500_000``), each
    held against K9's output; runs ``solve_refined(tol=1e-8,
    subcycle=True)`` with the counters zeroed just before (relres < 1e-8
    within 4 rounds, K9 launched, K1/K2 only at L0, no K4) and 400
    ``run_fixed_cycles`` on b = A·1 (relres < 1e-5, exactly updown 399,
    sub 400, down 1, up 1, tail 0); and times a V-cycle and a fixed cycle
    with and without the subcycle;
13. spawns 4 ranks of the slab-sharded tier on the one card (gloo, the edge
    rows staged through host memory); each sets up the flagship of phase
    4 and its 4-slab hierarchy (a 1024 × 4096 fine slab), drives K8
    through ``lat2d_spmv_halo(overlap=True)`` 5 times with the counters
    zeroed just before (exactly 10 K8 launches: interior and boundary
    parts), holds K8 against its plain version on the same halo and
    against ``overlap=False`` at 4096² (float32 and float64, to 1e-6 and
    1e-14 relative), on slabs of exactly 2·reach rows and 77 columns and
    on the 9-point L2 (456²), and runs the slab V-cycle from zero and
    ``solve_lattice_sharded(tol=1e-6)`` on b = A·1; this process gathers
    the slabs against the single-card SpMV of the whole grid, the V-cycle
    against n_sh = 1 (2e-5) and the single-card masked-sweep cycle (2e-4),
    the solve against its tolerance, scipy's float64 residual (< 1e-4) and
    n_sh = 1's iterations (±1), and times K8 on the whole 4096² grid (one
    slab), its plain version and ``torch.sparse.mm`` on the same operator
    as CSR.  With 4 or more cards the same runs under NCCL, a card per
    rank; with fewer it prints that NCCL across cards was not run;
14. lowers the flagship of phase 4 a third time with bf16 coefficient
    planes (``coef_dtype=torch.bfloat16``, ``bench.py``'s default
    ``AMG_COEF_DTYPE=bfloat16``) and asserts 8 levels, tail start 2, the
    legs' A, D⁻¹, T and S in bf16, the tail levels' A, T and S in bf16 with
    D⁻¹ and the coarse operator in float32, every level's own operator in
    float32, and the tile plans of float32; holds K1 (L0, L1, ``x_zero``
    both ways), K2 (L0 pipelined, L1), K3 (L0, L1) and K4 (``x_zero`` both
    ways) on the bf16 planes against their plain versions (max relative
    error <= 1e-5) and times each in turns with its float32 kernel on the
    same vectors (f32, bf16, bf16, f32), beside its bound with 2-byte
    planes; runs ``solve_refined(tol=1e-8)`` on b = A·1 and 400
    ``run_fixed_cycles`` with the counters zeroed just before each
    (relres < 1e-8 within 4 rounds; < 1e-5 after the cycles, with exactly
    phase 5's launches, by kernel and by level, and K3's 399 all on its
    staged route, ``csrc/updown_stage.cuh``), holds the staged K3 at L0
    bitwise against the tiled K3 and times the two in turns (``route_ms``),
    and times a V-cycle and a fixed cycle in turns with float32's;
15. does the same in float64 (``bench.py``'s ``AMG_BENCH_DTYPE=float64``
    under its default bf16 planes): the legs' planes bf16 (rounded from
    float32), the tail's A, T, S bf16 with D⁻¹ and the coarse operator in
    float64, every level's operator float64, the float64 tiles with K2
    pipelined at L0; K1–K4's ``f64_bf16`` entries against their plain
    versions (max relative error <= 1e-10) and timed in turns with the
    float64 entries; ``solve_refined`` (< 1e-8 within 4 rounds) and 400
    fixed cycles on b = A·1 (< 1e-10, launches equal to the same loop on
    float64 planes, run here);
16. lowers phase 10's 256³ hierarchy with bf16 planes under float32
    (``bench.py``'s 3-D cell): asserts 5 levels + an 8-row QR, OC 1.14878,
    L0's LatND A, P, R in bf16 with K7 on them, L1–L4 as phase 10 in
    float32; holds K7's ``f32_bf16`` entry against its plain version at L0
    and times it in turns with phase 10's float32 K7, beside its bound with
    2-byte planes; runs ``cg_device(tol=1e-6)`` with the counters zeroed
    just before (relres < 1e-5 against the float64 LatND operator, its
    iterations within 2 of phase 10's), and counts one V-cycle (2 K7 and
    the hierarchy's K6 launches) and times it in turns with phase 10's;
17. sets up ``bench.py``'s ``AMG_BENCH_METHOD=rs`` at 4096²: ``ruge_stuben``
    with ``StructuredRS`` and multicolor GS (the structured fast path;
    setup seconds printed), asserts 10 levels, OC 4.536 and a 6624-row
    coarse solve, no legs and no tail, K5 on every Lat2D level (the
    semi-coarsened levels' 11- to 45-point stencils, past 32 offsets
    through K5's wide instance), holds K5 against its plain version on each
    and times it, runs ``solve_refined(tol=1e-8)`` and 400
    ``run_fixed_cycles`` on b = A·1 with the counters zeroed just before
    each (rounds, PCG iterations and the cycles' relres printed), and
    counts one V-cycle (exactly 2 K5 launches on each Lat2D level and the
    K6 launches of its BSG levels, derived from the hierarchy) and times it
    by CUDA events;
18. drives the public API tier into the non-factored R/P-plane branches:
    (a) ``amt.solve(LP, A·1, SmoothedAggregationAMG(),
    aggregate=StructuredAggregation(box=3), symmetry=NoSymmetry(),
    presmoother=postsmoother=GaussSeidel(ordering="multicolor"),
    engine="torch", dtype=float32, coef_dtype=bfloat16, reltol=1e-5)`` with
    the counters zeroed just before (setup, lowering and V-cycles on the
    card): asserts 8 levels, OC 1.225, tail start 2, the legs of L0 and L1
    and the tail non-factored (legs' A, D⁻¹, R, P bf16; the tail's A, P
    bf16 with R and D⁻¹ float32), the K1/K2 tiles of L0 and L1 and K4's
    down and up tiles of its grid levels L2 and L3 as planned, and exactly
    the non-factored K1/K2 on L0 and L1 (all in tiles) and K4 once a
    V-cycle, no other kernel and no masked sweep;
    (b) ``save_hierarchy`` → ``load_hierarchy`` of phase 4's flagship (no
    factored stash: non-factored legs and tail) → ``solve_refined(tol=1e-8,
    coef_dtype=bfloat16)`` (< 1e-8 within 4 rounds, the counters zeroed
    just before); (c) the non-factored K1 (L0, L1, ``x_zero`` both ways),
    K2 (L0, L1) and K4 (``x_zero`` both ways) on bf16 and on float32 planes
    against their plain versions (max relative error <= 1e-5), each timed
    in turns with the factored entry on phase 4's hierarchy on the same
    vectors (factored, nf, nf, factored), beside its 2-byte and 4-byte
    bound, and each against and in turns with its pass route (pass, tiles,
    tiles, pass): K1/K2 with their tiles taken away, K4 on the same levels
    with its grid levels' tiles set to (0, 0) through
    ``make_fused_tail_cache``; (d) a V-cycle and a fixed cycle,
    non-factored and factored, timed in turns, and one V-cycle of each on
    the same x and b with float32 planes held to 1e-5 (2-norm: the same P
    two ways);
19. lowers the flagship with ``subcycle=True`` and bf16 planes in float32
    and float64: asserts ``sub_start`` 1, ``tail_start`` 2, the subcycle's
    A, T, S in bf16 with D⁻¹ and the coarse operator at the vectors' dtype
    (the top level rounded like a tail level, not the legs' cache), L0's
    legs bf16; holds K9's ``f32_bf16`` / ``f64_bf16`` entries against the
    plain version at L1 (1366²) and at L1 of the 192² problem with a
    600-row tail (max relative error <= 1e-5 / 1e-12), times each in turns
    with K9 on the vectors' own planes beside its 2-byte bound; runs
    ``solve_refined(tol=1e-8, subcycle=True, coef_dtype=bfloat16)`` (< 1e-8
    within 4 rounds, K9 launched, no K4, K1/K2 only at L0) and 400
    ``run_fixed_cycles`` on b = A·1 (< 1e-5, exactly updown 399, sub 400,
    down 1, up 1, tail 0) with the counters zeroed just before each, and a
    float64 V-cycle (K1/K2 once, K9 once);
20. runs the generic sharded tier on 4 gloo ranks sharing the card:
    (a) ``solve_sharded`` on the flagship (multicolor GS, float32, reltol
    1e-5) with the counters zeroed just before: the iterations of
    ``solve_sharded`` at n_sh = 1 in this process, x within 1e-5 of it in
    the 2-norm and the same on every rank, no K1–K4 or K9 launch; the L0
    SpMV and V-cycle times per rank beside the single card's (CUDA events);
    (b) ``solve_sharded`` on the scrambled 1024² problem, whose one
    V-cycle launches K6 on every rank exactly as often as the single-card
    count derived from the hierarchy; (c) ``rap_planes_sharded`` at L0 of
    the 4-slab flagship against ``ml.levels[1].A.spec.expand_all()`` (5e-6
    relative); (d) ``entry.dryrun_multichip(4)``; with 4 or more cards
    (a)–(c) again under NCCL, a card a rank, else it prints that NCCL was
    not run; each part's seconds.

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
# the per-pass designs that the tiled K1, K2 (by level), K3 and K4 (and K9
# on K4's tail) replaced, and the fixed cycle before K3 and K4 were tiled:
# recorded constants, not measured in this run (this script's phases 3, 5
# and 12 on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6), printed in the
# log beside this run's times and never in the kernels line
FIRST_DESIGN_MS = {
    ("fused_down", 0): 1.385, ("fused_down", 1): 0.346, ("fused_up", 0): 1.094, ("fused_up", 1): 0.287,
    ("fused_updown", 0): 2.260, ("fused_tail", EXPECT_TAIL_START): 0.395, ("fused_subcycle", 1): 1.037,
}
FIRST_DESIGN_FIXED_CYCLE_MS = "3.33-3.39"
SOURCES = {
    "fused_down": "algebraicmultigrid_tpu_torch/csrc/vcycle_legs.cu",
    "fused_up": "algebraicmultigrid_tpu_torch/csrc/vcycle_legs.cu",
    "fused_updown": "algebraicmultigrid_tpu_torch/csrc/vcycle_legs.cu",
    "fused_tail": "algebraicmultigrid_tpu_torch/csrc/tail_kernel.cu",
    "bsg_spmv": "algebraicmultigrid_tpu_torch/csrc/bsg_spmv.cu",
    "scan_gs": "algebraicmultigrid_tpu_torch/csrc/scan_gs.cu",
    "gs_sweep": "algebraicmultigrid_tpu_torch/csrc/gs_sweep.cu",
    "sweep3d": "algebraicmultigrid_tpu_torch/csrc/sweep3d.cu",
    "fused_subcycle": "algebraicmultigrid_tpu_torch/csrc/subcycle_kernel.cu",
    "halo_stencil": "algebraicmultigrid_tpu_torch/csrc/halo_stencil.cu",
    "fused_down_nf": "algebraicmultigrid_tpu_torch/csrc/vcycle_legs.cu",
    "fused_up_nf": "algebraicmultigrid_tpu_torch/csrc/vcycle_legs.cu",
    "fused_tail_nf": "algebraicmultigrid_tpu_torch/csrc/tail_nf_kernel.cu",
}
REPLACES = {
    "fused_down": "algebraicmultigrid_tpu/ops/pallas/vcycle_kernels.py:1432",
    "fused_up": "algebraicmultigrid_tpu/ops/pallas/vcycle_kernels.py:1736",
    "fused_updown": "algebraicmultigrid_tpu/ops/pallas/vcycle_kernels.py:2222",
    "fused_tail": "algebraicmultigrid_tpu/ops/pallas/tail_kernel.py:451",
    "bsg_spmv": "algebraicmultigrid_tpu/ops/bsg.py:189",
    # not a Pallas kernel: the XLA lax.scan recurrence of natural-order GS
    "scan_gs": "algebraicmultigrid_tpu/models/device.py:277 (_scan_sweep, an XLA lax.scan, not a Pallas kernel)",
    "gs_sweep": "algebraicmultigrid_tpu/ops/pallas/gs_kernel.py:298",
    "sweep3d": "algebraicmultigrid_tpu/ops/pallas/sweep3d_kernel.py:209",
    "fused_subcycle": "algebraicmultigrid_tpu/ops/pallas/subcycle_kernel.py:310",
    "halo_stencil": "algebraicmultigrid_tpu/parallel/async_halo.py:80",
    # the non-factored (R/P-plane) else branches of the same Pallas kernels
    "fused_down_nf": "algebraicmultigrid_tpu/ops/pallas/vcycle_kernels.py:1539",
    "fused_up_nf": "algebraicmultigrid_tpu/ops/pallas/vcycle_kernels.py:1816",
    "fused_tail_nf": "algebraicmultigrid_tpu/ops/pallas/tail_kernel.py:519",
}
COUNTER = {
    "fused_down": "down", "fused_up": "up", "fused_updown": "updown", "fused_tail": "tail",
    "bsg_spmv": "bsg", "scan_gs": "scan_gs", "gs_sweep": "gs", "sweep3d": "sweep3d", "fused_subcycle": "sub",
    "halo_stencil": "halo", "fused_down_nf": "down_nf", "fused_up_nf": "up_nf", "fused_tail_nf": "tail_nf",
}
# the unstructured problem: bench.py's scrambled Poisson
NU = 1024
NU_SEED = 1
U_LEVELS = 5
U_COARSE = (1, 1)
U_BSG_LEVELS = (0, 1, 2)
U_COLORS = (2, 9, 10)  # the natural-order greedy coloring's, as in the JAX package
U_CG_TOL = 1e-6
# an f32 solution vector cannot hold an f64-checked relative residual much
# below ||A|| * eps_f32 * ||x|| / ||b||: at 1024² that floor is ~1e-5, so the
# caller's-order scipy check of cg_device's answer is held to this bound,
# and the 1e-6 to its own residual (solve_refined reaches 1e-8 in f64)
U_CG_TRUE = 1e-4


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


def in_turns(fn_a, fn_b, reps=TIMED_REPS):
    """Milliseconds of a and b timed in turns (a, b, b, a): (mean a, mean
    b, the four times)."""
    t = [time_ms(f, reps) for f in (fn_a, fn_b, fn_b, fn_a)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


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


def plane_words(leg, correct=True, restrict=True):
    """Words at the vectors' itemsize of the planes a level's legs read, each
    at its own itemsize (a bf16 plane is half a float32 word a cell): A,
    D⁻¹ and T, S; non-factored, R (over the coarse grid) for a restriction
    and P for a correction."""
    planes = (leg.A, leg.dinv, leg.T, leg.S, leg.R if restrict else None, leg.P if correct else None)
    return sum(p.numel() * p.element_size() for p in planes if p is not None) / leg.dtype.itemsize


def leg_work(leg, steps, correct, restrict, x_zero=False):
    """(words moved, flops) of one leg's passes on one level: the A planes,
    dinv, T, S and b read, x written, and x read unless it starts at zero;
    x_c read for a correction, b_c written for a restriction.  Words are at
    the vectors' itemsize (``plane_words``)."""
    Wx, Wy = leg.row_dims
    n = Wx * Wy
    nc = leg.col_dims[0] * leg.col_dims[1]
    nA = len(leg.offsA)
    cells = _color_cells(leg)
    words = plane_words(leg, correct, restrict) + 2 * n
    flops = sum(cells.get(c, 0) * (2 * nA + 3) for c in steps)
    if not x_zero:
        words += n
    if correct:
        words += nc
        if leg.factored:
            flops += n * (3 * nA + 4)  # T·x_c at each neighbour, the stencil, S
        else:
            flops += n * (2 * len(leg.offsP) + 1)  # the P-plane sum and the add
    if restrict:
        words += nc
        if leg.factored:
            flops += n * (2 * nA + 2) + n * (2 * nA + 3) + n  # residual and g, terms, box sums
        else:
            flops += n * (2 * nA + 1) + nc * 2 * len(leg.offsR)  # residual, the R-plane sum
    return words, flops


def bound(words, flops, itemsize, flops_s=F32_FLOPS):
    """(bound_ms, bound_by) on the H100's published peaks (``flops_s`` the
    vectors' type's rate)."""
    t_bytes = words * itemsize / HBM_BYTES_S * 1e3
    t_ops = flops / flops_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tail_work(tail, x_zero):
    """(words, flops) of one whole-tail cycle: every level's planes and Mc
    read once, the entry level's b (and x unless zero) read and x written;
    the coarser levels' vectors never leave the kernel's work buffer."""
    n0 = tail.levels[0].row_dims[0] * tail.levels[0].row_dims[1]
    words = tail.Mc.numel() + (2 if x_zero else 3) * n0
    flops = 2 * tail.Mc.numel()
    for leg in tail.levels:
        words += plane_words(leg)
        flops += leg_work(leg, leg.steps, False, True)[1] + leg_work(leg, leg.steps, True, False)[1]
    return words, flops


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def compare_kernels(device, ml):
    """Phase 3: every kernel against its plain version at the main path's
    shapes, with kernel, plain and K1/K2-route times; K1/K2 tiled as
    planned at L0 and L1, timed in turns against their pass-by-pass route."""
    import dataclasses

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

    rows = {name: [] for name in ("fused_down", "fused_up", "fused_updown", "fused_tail")}

    def record(name, got, ref, fn, plain, work, route=None, **extra):
        """A row: errors against the plain version, kernel and plain times;
        with ``route`` (the same leg pass by pass) its error, and kernel
        and route timed in turns."""
        errs = [errors(g, r) for g, r in zip(got, ref)]
        row = dict(extra, max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs), work=work)
        if route is None:
            row["ms"] = time_ms(fn)
        else:
            out = route()
            row["route_rel_err"] = max(errors(g, r)[1] for g, r in zip(out if isinstance(out, tuple) else [out], ref))
            row["ms"], row["route_ms"], row["turns_ms"] = in_turns(fn, route)
        row["plain_ms"] = time_ms(plain)
        rows[name].append(row)

    for lvl in (0, 1):
        L = h.levels[lvl]
        f = L.fused
        if f is None:
            raise AssertionError(f"level {lvl} has no fused legs")
        planned = (vl.plan_down(f.row_dims, f.k, f.offsA, len(f.steps)),
                   vl.plan_up(f.row_dims, f.k, f.offsA, len(f.steps)))
        if None in planned or (f.down_tile, f.up_tile) != planned:
            raise AssertionError(f"level {lvl}'s K1/K2 tiles {(f.down_tile, f.up_tile)} are not the plan's {planned}")
        passed = dataclasses.replace(f, down_tile=None, up_tile=None, up_pipelined=False)
        n, pad, nc = L.A.shape[0], L.A.rows_padded, L.R.shape[0]
        x, b, xc = vec(n, pad), vec(n, pad), vec(nc, nc)
        for x_zero in (False, True):
            record(
                "fused_down", vl.fused_down(f, x, b, x_zero=x_zero),
                vl.fused_down_reference(f, x, b, x_zero=x_zero),
                lambda: vl.fused_down(f, x, b, x_zero=x_zero),
                lambda: vl.fused_down_reference(f, x, b, x_zero=x_zero),
                leg_work(f, f.steps, False, True, x_zero=x_zero),
                route=lambda: vl.fused_down(passed, x, b, x_zero=x_zero),
                level=lvl, dims=f.row_dims, x_zero=x_zero, leg_route="tiles", tile=f.down_tile,
            )
        record(
            "fused_up", [vl.fused_up(f, x, b, xc)], [vl.fused_up_reference(f, x, b, xc)],
            lambda: vl.fused_up(f, x, b, xc), lambda: vl.fused_up_reference(f, x, b, xc),
            leg_work(f, f.steps, True, False), route=lambda: vl.fused_up(passed, x, b, xc),
            level=lvl, dims=f.row_dims, leg_route="pipelined" if f.up_pipelined else "tiles", tile=f.up_tile,
        )
        record(
            "fused_updown", vl.fused_updown(f, x, b, xc), vl.fused_updown_reference(f, x, b, xc),
            lambda: vl.fused_updown(f, x, b, xc), lambda: vl.fused_updown_reference(f, x, b, xc),
            leg_work(f, f.steps2, True, True), level=lvl, dims=f.row_dims,
            leg_route="staged" if f.updown_staged else "tiles", tile=f.updown_tile,
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
                + (f" {r['leg_route']} {r['tile']}" if "leg_route" in r else "")
                + f" kernel {r['ms']!r} ms plain {r['plain_ms']!r} ms"
                + (f" legs {r['legs_ms']!r} ms" if "legs_ms" in r else "")
                + (f" pass route {r['route_ms']!r} ms (in turns, kernel/route/route/kernel:"
                   f" {r['turns_ms']!r}; route max_rel_err {r['route_rel_err']!r})" if "route_ms" in r else "")
                + (f" (first design, recorded: {FIRST_DESIGN_MS[name, r['level']]!r} ms)"
                   if (name, r["level"]) in FIRST_DESIGN_MS and not r.get("x_zero") else "")
                + f" bound {r['bound_ms']!r} ms ({r['bound_by']})")
            if not r["max_rel_err"] <= KERNEL_RTOL:
                raise AssertionError(f"{name} disagrees with its plain version: {r}")
            if not r.get("route_rel_err", 0.0) <= KERNEL_RTOL:
                raise AssertionError(f"{name}'s pass route disagrees with the plain version: {r}")
    return rows


def zero_counts():
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    for key in vl.launches:
        vl.launches[key] = 0
    vl.level_launches.clear()
    vl.route_launches.clear()


def read_level_counts():
    """The leg and whole-sweep kernels' launches by level: {counter:
    {"Wx×Wy": count}} (K5's grids as "Wx×1×Wy")."""
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    out = {}
    for (name, dims), count in sorted(vl.level_launches.items()):
        out.setdefault(name, {})["x".join(str(d) for d in dims)] = count
    return out


def read_counts():
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    return dict(vl.launches)


def read_route_counts():
    """K1's, K2's and K3's launches by route: {"counter/route": count}."""
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    return {f"{name}/{route}": count for (name, route), count in sorted(vl.route_launches.items()) if count}


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
    by_level = read_level_counts()

    levels = len(ml.levels) + 1
    oc = ml.operator_complexity()
    relres = float(np.linalg.norm(b - ml.levels[0].A @ x) / np.linalg.norm(b))
    log(f"main path {N}x{N}: levels {levels} operator_complexity {oc!r}")
    log(f"level dims {[L.A.row_dims for L in h.levels]} fused {[L.fused is not None for L in h.levels]}"
        f" tail_start {h.tail_start}; K1/K2 tiles at L0, L1"
        f" {[(L.fused.down_tile, L.fused.up_tile, L.fused.up_pipelined) for L in h.levels[:2]]}")
    log(f"setup_s {setup_s!r} lowering_s {t2 - t1!r} solve_s {t3 - t2!r}")
    log(f"refine rounds {len(hist) - 1} pcg_iters_per_round {stats['inner_iters']} history {hist}")
    log(f"solve_relres {relres!r}")
    log(f"launches in the solve {counts}; leg launches by level {by_level}")

    bv = torch.zeros(h.fine_padded, device=device)
    bv[: N * N] = torch.as_tensor(b, dtype=torch.float32, device=device)
    xv = torch.zeros_like(bv)
    vcycle_ms = time_ms(lambda: _one_iteration(h, amt.V(), xv, bv), reps=10)
    h_plain = amt.build_device_hierarchy(ml, device=device, dtype=torch.float32, fused=False, tail=False)
    plain_vcycle_ms = time_ms(lambda: _one_iteration(h_plain, amt.V(), xv, bv), reps=10)
    del h_plain
    log(f"vcycle_ms (CUDA events) kernels {vcycle_ms!r} plain {plain_vcycle_ms!r}")

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
    if not all(L.fused.down_tile and L.fused.up_tile for L in h.levels[:2]):
        raise AssertionError("the main path's L0 and L1 legs are not tiled")
    return h, counts, by_level, vcycle_ms


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
    by_level = read_level_counts()
    routes = read_route_counts()
    ms_per_cycle = start.elapsed_time(stop) / CYCLES
    xh = x[: N * N].double().cpu().numpy()
    relres = float(np.linalg.norm(b - ml.levels[0].A @ xh) / np.linalg.norm(b))
    log(f"fixed cycles {CYCLES}: ms_per_cycle (CUDA events) {ms_per_cycle!r}"
        f" (first design, recorded: {FIRST_DESIGN_FIXED_CYCLE_MS} ms) relres_after_cycles {relres!r}")
    log(f"launches in the fixed cycles {counts}; leg launches by level {by_level}; by route {routes}")

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
    want = {"updown": CYCLES - 1, "tail": CYCLES, "down": CYCLES + 1, "up": CYCLES + 1, "sub": 0, "bsg": 0,
            "scan_gs": 0, "gs": 0, "sweep3d": 0, "halo": 0, "down_nf": 0, "up_nf": 0, "tail_nf": 0}
    if counts != want:
        raise AssertionError(f"fixed-cycle launches {counts} != {want}")
    l0, l1 = (f"{d[0]}x{d[1]}" for d in (h.levels[0].fused.row_dims, h.levels[1].fused.row_dims))
    want_levels = {"down": {l0: 1, l1: CYCLES}, "up": {l0: 1, l1: CYCLES}, "updown": {l0: CYCLES - 1}}
    if by_level != want_levels:
        raise AssertionError(f"fixed-cycle leg launches by level {by_level} != {want_levels}")
    # K3 in tiles: the staged route takes bf16 planes only (phase 14 stages it)
    want_k3 = {"updown/tiles": CYCLES - 1}
    if {k: v for k, v in routes.items() if k.startswith("updown/")} != want_k3:
        raise AssertionError(f"fixed-cycle K3 launches by route {routes} != {want_k3}")
    if not all(fixed_rel[k] <= tol for k, tol in FIXED_RTOL.items()):
        raise AssertionError(f"fixed cycles disagree with iterated cycles: {fixed_rel}")
    return counts, by_level, ms_per_cycle


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


# --------------------------------------------------------------------------
# the unstructured path (phases 7-9)
# --------------------------------------------------------------------------


def unstructured_setup(device):
    """Phase 7: bench.py's scrambled Poisson through SA and the lowering;
    returns (permuted CSR, hierarchy, device hierarchy)."""
    import scipy.sparse as sp
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import ScanGSCache
    from algebraicmultigrid_tpu_torch.ops.bsg import BSG, rcm_permutation
    from algebraicmultigrid_tpu_torch.ops.coloring import graph_coloring
    from algebraicmultigrid_tpu_torch.ops.sparse import ELL

    A = sp.csr_matrix(amt.poisson((NU, NU)))
    p = np.random.default_rng(NU_SEED).permutation(A.shape[0])
    Ap = A[p][:, p].tocsr()
    t0 = time.perf_counter()
    ml = amt.smoothed_aggregation(Ap)
    t1 = time.perf_counter()
    h = amt.get_device_hierarchy(ml, device=device, dtype=torch.float32)
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    fmt = [(type(L.A).__name__, type(L.P).__name__, type(L.R).__name__, type(L.pre).__name__) for L in h.levels]
    colors = [getattr(L.pre, "n_colors", None) for L in h.levels]
    log(f"unstructured {NU}x{NU} scrambled: rows {[L.A.shape[0] for L in h.levels]} coarse {ml.final_A.shape}"
        f" operator_complexity {ml.operator_complexity()!r}")
    log(f"unstructured formats (A, P, R, smoother) {fmt} colors {colors} perm0 {h.perm0 is not None}")
    log(f"unstructured setup_s {t1 - t0!r} lowering_s {t2 - t1!r}")
    if len(h.levels) != U_LEVELS or ml.final_A.shape != U_COARSE:
        raise AssertionError(f"{len(h.levels)} levels and a {ml.final_A.shape} coarse solve,"
                             f" not {U_LEVELS} and {U_COARSE}")
    if h.perm0 is None:
        raise AssertionError("the fine level did not adopt the RCM basis")
    for i, L in enumerate(h.levels):
        if i in U_BSG_LEVELS:
            if not isinstance(L.A, BSG):
                raise AssertionError(f"level {i} lowered to {type(L.A).__name__}, not BSG")
            M = ml.levels[i].A.tocsr()
            pi = rcm_permutation(M)
            want = int(graph_coloring(M[pi][:, pi], assume_symmetric=True).max()) + 1
            if not L.pre.n_colors == L.post.n_colors == want == U_COLORS[i]:
                raise AssertionError(f"level {i} has {L.pre.n_colors} colors, its greedy coloring {want},"
                                     f" expected {U_COLORS[i]}")
        elif not (isinstance(L.A, ELL) and isinstance(L.pre, ScanGSCache) and isinstance(L.post, ScanGSCache)):
            raise AssertionError(f"level {i} is {fmt[i]}, not ELL with natural-order GS")
    return Ap, ml, h


def bsg_to_csr(B):
    """The float32 CSR matrix a BSG operator holds (its stored entries)."""
    import scipy.sparse as sp

    data = B.data.cpu().numpy()
    T, K = data.shape[:2]
    keep = data != 0
    t, _, u, j = np.nonzero(keep)
    rows = t * 1024 + u * 128 + j
    cols = B.m0.cpu().numpy()[t].astype(np.int64) * 128 + B.off.cpu().numpy()[keep]
    M = sp.csr_matrix((data[keep], (rows, cols)), shape=B.shape)
    M.sort_indices()
    return M


def bsg_work(B):
    """(bytes, flops) of one BSG SpMV: coefficients, offsets and m0 read
    once, x's columns read once, y written once; 2 flops a stored entry."""
    return B.data.numel() * 8 + B.m0.numel() * 4 + B.shape[1] * 4 + B.rows_padded * 4, 2 * B.nnz


def scan_gs_work(A, cache):
    """(bytes, flops) of one natural-order smoother application: the level's
    split halves (data and int16 columns), dshift, diag, b and x in once and
    x out once; 2 flops a stored entry plus 6 a row, per sweep."""
    sp = cache.split
    itemsize = A.data.element_size()
    sweeps = cache.iter * (int(cache.forward) + int(cache.backward))
    halves = (sp.lo_data.numel() + sp.up_data.numel()) * (itemsize + 2)
    return halves + A.rows_padded * 5 * itemsize, sweeps * (2 * A.nnz + 6 * A.shape[0])


def compare_unstructured_kernels(device, ml, h):
    """Phase 8: K6 at the L0/L1/L2 shapes against its plain version and
    cuSPARSE, and scan_gs on L3/L4 against its plain version, timed in turns
    against its streamed route."""
    import dataclasses

    import torch

    from algebraicmultigrid_tpu_torch.models.device import ScanGSCache
    from algebraicmultigrid_tpu_torch.ops.kernels.bsg_spmv import bsg_spmv, bsg_spmv_reference
    from algebraicmultigrid_tpu_torch.ops.kernels.scan_gs import smooth_scan_gs, smooth_scan_gs_reference

    gen = torch.Generator(device="cpu").manual_seed(2)
    rows = {"bsg_spmv": [], "scan_gs": []}
    for lvl in U_BSG_LEVELS:
        B = h.levels[lvl].A
        x = torch.randn(B.rows_padded, generator=gen).to(device)
        got, ref = bsg_spmv(B, x), bsg_spmv_reference(B, x)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(got, ref)
        # the same matrix as cuSPARSE CSR, read back from the BSG arrays
        Mp = bsg_to_csr(B)
        S = torch.sparse_csr_tensor(
            torch.as_tensor(Mp.indptr, dtype=torch.int64), torch.as_tensor(Mp.indices, dtype=torch.int64),
            torch.as_tensor(Mp.data), size=Mp.shape,
        ).to(device)
        xs = x[: Mp.shape[1]].contiguous()
        lib_err = errors((S @ xs), got[: Mp.shape[0]])[1]
        r = dict(
            level=lvl, rows=B.shape[0], K=B.width, ws=B.ws, nnz=B.nnz,
            max_abs_err=abs_err, max_rel_err=rel_err, cusparse_rel_diff=lib_err,
            ms=time_ms(lambda: bsg_spmv(B, x)), plain_ms=time_ms(lambda: bsg_spmv_reference(B, x)),
            library_ms=time_ms(lambda: S @ xs),
        )
        r["bound_ms"], r["bound_by"] = bound(*bsg_work(B), 1)
        rows["bsg_spmv"].append(r)
        del S
    for lvl, L in enumerate(h.levels):
        if not isinstance(L.pre, ScanGSCache):
            continue
        c, A = L.pre, L.A
        x = torch.randn(A.rows_padded, generator=gen).to(device)
        b = torch.randn(A.rows_padded, generator=gen).to(device)
        # the planned route against the streamed one (the halves in device
        # memory), in turns
        streamed = dataclasses.replace(c, split=dataclasses.replace(c.split, route="streamed"))
        ref = smooth_scan_gs_reference(A, c.diag, x, b, c.omega, c.iter, c.forward, c.backward)
        got, got_s = smooth_scan_gs(A, c, x, b), smooth_scan_gs(A, streamed, x, b)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(got, ref)
        ms, streamed_ms, turns = in_turns(lambda: smooth_scan_gs(A, c, x, b), lambda: smooth_scan_gs(A, streamed, x, b))
        r = dict(
            level=lvl, rows=A.shape[0], K=A.width, nnz=A.nnz, max_abs_err=abs_err, max_rel_err=rel_err,
            route=c.split.route, halves=(c.split.lo_data.shape[0], c.split.up_data.shape[0]),
            streamed_rel_err=errors(got_s, ref)[1], ms=ms, streamed_ms=streamed_ms, turns_ms=turns,
            plain_ms=time_ms(lambda: smooth_scan_gs_reference(A, c.diag, x, b, c.omega, c.iter, c.forward,
                                                              c.backward), reps=2),
            library_ms=None,
        )
        r["bound_ms"], r["bound_by"] = bound(*scan_gs_work(A, c), 1)
        rows["scan_gs"].append(r)
    for name, rs in rows.items():
        for r in rs:
            log(f"kernel {name} L{r['level']} rows {r['rows']} K {r['K']}: max_rel_err {r['max_rel_err']!r}"
                f" max_abs_err {r['max_abs_err']!r} kernel {r['ms']!r} ms plain {r['plain_ms']!r} ms"
                + (f" cusparse {r['library_ms']!r} ms (rel diff {r['cusparse_rel_diff']!r})" if r["library_ms"] else "")
                + (f" route {r['route']} halves {r['halves']}; streamed route {r['streamed_ms']!r} ms"
                   f" (in turns, kernel/streamed/streamed/kernel: {r['turns_ms']!r}; streamed max_rel_err"
                   f" {r['streamed_rel_err']!r})" if "route" in r else "")
                + f" bound {r['bound_ms']!r} ms ({r['bound_by']})")
            if not max(r["max_rel_err"], r.get("streamed_rel_err", 0.0)) <= KERNEL_RTOL:
                raise AssertionError(f"{name} disagrees with its plain version: {r}")
    return rows


def expected_vcycle_launches(h):
    """(K6, scan_gs) launches of one V-cycle, from the hierarchy: per BSG
    level its smoothers' color steps, the residual and each BSG transfer;
    one scan_gs launch per natural-order smoother application."""
    from algebraicmultigrid_tpu_torch.models.device import MaskedMulticolorCache, ScanGSCache
    from algebraicmultigrid_tpu_torch.ops.bsg import BSG
    from algebraicmultigrid_tpu_torch.ops.coloring import color_steps

    bsg = scan = 0
    for L in h.levels:
        for c in (L.pre, L.post):
            if isinstance(c, ScanGSCache):
                scan += 1
            elif isinstance(c, MaskedMulticolorCache) and isinstance(L.A, BSG):
                bsg += len(color_steps(c.n_colors, c.iter, c.forward, c.backward, c.omega))
        bsg += isinstance(L.A, BSG) + isinstance(L.P, BSG) + isinstance(L.R, BSG)
    return bsg, scan


def unstructured_solve(device, Ap, ml, h):
    """Phase 9: cg_device and solve_refined on the unstructured problem with
    the counters zeroed just before; then one V-cycle's launches and time."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _enter_basis, _one_iteration

    b = np.random.default_rng(0).standard_normal(Ap.shape[0])
    normb = np.linalg.norm(b)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    x_cg, iters, normr = amt.cg_device(ml, b, tol=U_CG_TOL, device=device, dtype=torch.float32, log=True)
    t1 = time.perf_counter()
    stats = {}
    x_ref, hist = amt.solve_refined(ml, b, tol=TOL, max_rounds=MAX_ROUNDS, device=device, log=True, stats=stats)
    t2 = time.perf_counter()
    counts = read_counts()
    # again, with the float64 fine operator already lowered
    amt.solve_refined(ml, b, tol=TOL, max_rounds=MAX_ROUNDS, device=device)
    t3 = time.perf_counter()
    relres_cg = float(np.linalg.norm(b - Ap @ x_cg) / normb)
    relres_ref = float(np.linalg.norm(b - Ap @ x_ref) / normb)
    log(f"unstructured cg_device: {iters} iterations, its own relres {float(normr / normb)!r},"
        f" scipy float64 relres {relres_cg!r}, {t1 - t0!r} s")
    log(f"unstructured solve_refined: rounds {len(hist) - 1} pcg_iters_per_round {stats['inner_iters']}"
        f" relres {relres_ref!r} history {hist} {t2 - t1!r} s (again: {t3 - t2!r} s)")
    log(f"launches in the unstructured solves {counts}")

    want = expected_vcycle_launches(h)
    bv = _enter_basis(h, torch.as_tensor(np.pad(b, (0, h.fine_padded - b.shape[0])), dtype=torch.float32,
                                         device=device))
    xv = torch.zeros_like(bv)
    torch.cuda.synchronize()
    zero_counts()
    _one_iteration(h, amt.V(), xv, bv)
    torch.cuda.synchronize()
    per_cycle = read_counts()
    vcycle_ms = time_ms(lambda: _one_iteration(h, amt.V(), xv, bv), reps=10)
    log(f"unstructured vcycle_ms {vcycle_ms!r}; launches per V-cycle {per_cycle};"
        f" expected bsg {want[0]} scan_gs {want[1]}")

    for name, x in (("cg_device", x_cg), ("solve_refined", x_ref)):
        if not (x.shape == b.shape and np.isfinite(x).all()):
            raise AssertionError(f"{name}: the solution is not a finite vector of the problem's size")
    if not (normr / normb < U_CG_TOL and relres_cg < U_CG_TRUE):
        raise AssertionError(f"cg_device relres {normr / normb} (scipy: {relres_cg})")
    if not (relres_ref < TOL and len(hist) - 1 <= MAX_ROUNDS):
        raise AssertionError(f"solve_refined relres {relres_ref} after {len(hist) - 1} rounds")
    if not (counts["bsg"] > 0 and counts["scan_gs"] > 0):
        raise AssertionError(f"the unstructured solves did not launch K6 and scan_gs: {counts}")
    if (per_cycle["bsg"], per_cycle["scan_gs"]) != want:
        raise AssertionError(f"V-cycle launches {per_cycle} != expected bsg/scan_gs {want}")
    return counts, per_cycle


# --------------------------------------------------------------------------
# the 3-D path (phase 10) and the 2-D path without legs (phase 11)
# --------------------------------------------------------------------------

N3 = 256
N3_KW = dict(proxy=47, cut_rows=20000)
N3_ROWS = (16_777_216, 636_056, 24_389, 1_000, 64)
N3_COARSE = 8
N3_OC = 1.14878
# the JAX package's lowering of L1-L4 at 256^3
N3_FORMATS = [("SDIA", "BSG", "ELL"), ("SDIA", "BSG", "ELL"), ("SDIA", "DenseOp", "DenseOp"), ("SDIA", "SDIA", "SDIA")]
ODD3 = (13, 9, 100)
SWEEP_RTOL = {"float32": KERNEL_RTOL, "float64": 1e-12}
FB_LEVELS = 8
FB_K5_PER_VCYCLE = 14


def sweep_work(cache):
    """(words, flops) of one whole-sweep application: the planes, dinv, b
    and x read once and x written once (words at the vectors' itemsize, a
    bf16 plane half a float32 word a cell); per color step, 2 flops an
    offset plus 3 at each cell of that color."""
    n = int(np.prod(cache.dims))
    tab = np.asarray(cache.color_table).reshape(cache.periods)
    cells = {}
    for idx in np.ndindex(*tab.shape):
        count = int(np.prod([len(range(i, w, p)) for i, w, p in zip(idx, cache.dims, tab.shape)]))
        cells[int(tab[idx])] = cells.get(int(tab[idx]), 0) + count
    flops = sum(cells.get(c, 0) * (2 * len(cache.offsets) + 3) for c in cache.steps)
    planes = len(cache.offsets) * cache.A.data.element_size() / cache.A.dtype.itemsize
    return (planes + 4) * n, flops


def compare_sweep(name, fn, ref, cache, x, b, level, timed=True, tile=False):
    """One whole-sweep kernel against its plain version (and timed); with
    ``tile`` the halo-tile kernel (the kernel's first design, on the view
    ``tile_view`` gives once) is also held against the plain version and
    timed in turns against the kernel."""
    import torch

    from algebraicmultigrid_tpu_torch.ops.kernels.tiled_sweep import tile_view

    got, want = fn(cache, x, b), ref(cache, x, b)
    cache_tile = tile_view(cache) if tile else None
    got_tile = fn(cache_tile, x, b) if tile else None
    torch.cuda.synchronize()
    abs_err, rel_err = errors(got, want)
    key = str(x.dtype).removeprefix("torch.")
    route = "march" if cache.march else "tile"
    r = dict(level=level, dims=cache.dims, dtype=key, steps=cache.steps, route=route, box=cache.box,
             march=cache.march.args() if cache.march else None, max_abs_err=abs_err, max_rel_err=rel_err)
    if tile:
        r["tile_rel_err"] = errors(got_tile, want)[1]
    if timed:
        if not tile:
            r["ms"] = time_ms(lambda: fn(cache, x, b))
        else:
            r["ms"], r["tile_ms"], r["turns_ms"] = in_turns(lambda: fn(cache, x, b), lambda: fn(cache_tile, x, b))
        r["plain_ms"] = time_ms(lambda: ref(cache, x, b))
        r["bound_ms"], r["bound_by"] = bound(*sweep_work(cache), x.element_size())
    log(f"kernel {name} {level} dims {cache.dims} {key} steps {cache.steps} route {route}"
        f" {r['march'] if cache.march else cache.box}: max_rel_err {rel_err!r} max_abs_err {abs_err!r}"
        + (f" halo-tile kernel max_rel_err {r['tile_rel_err']!r}" if tile else "")
        + (f" kernel {r['ms']!r} ms plain {r['plain_ms']!r} ms bound {r['bound_ms']!r} ms ({r['bound_by']})"
           if timed else "")
        + (f"; halo-tile kernel {r['tile_ms']!r} ms (in turns, march/tile/tile/march: {r['turns_ms']!r})"
           if timed and tile else ""))
    if not max(rel_err, r.get("tile_rel_err", 0.0)) <= SWEEP_RTOL[key]:
        raise AssertionError(f"{name} disagrees with its plain version: {r}")
    return r


def lattice_3d(device):
    """Phase 10: the 3-D problem's setup, lowering, K7 checks, solves and
    per-V-cycle launches."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _get_fine_f64, _one_iteration
    from algebraicmultigrid_tpu_torch.models.lattice_nd import lattice_coloring_nd
    from algebraicmultigrid_tpu_torch.ops.banded import mat_vec
    from algebraicmultigrid_tpu_torch.ops.kernels.sweep3d import (
        Sweep3DCache, build_sweep3d_cache, smooth_sweep3d, smooth_sweep3d_reference,
    )
    from algebraicmultigrid_tpu_torch.ops.lattice_nd_op import latnd_from_spec

    t0 = time.perf_counter()
    ml = amt.structured_smoothed_aggregation_nd(amt.poisson((N3,) * 3, lattice=True), **N3_KW)
    t1 = time.perf_counter()
    h = amt.get_device_hierarchy(ml, device=device, dtype=torch.float32)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rows = tuple(L.A.shape[0] for L in ml.levels)
    oc = ml.operator_complexity()
    fmt = [(type(L.A).__name__, type(L.P).__name__, type(L.R).__name__) for L in h.levels]
    log(f"3-D {N3}^3: rows {rows} coarse {ml.final_A.shape} {type(ml.coarse_solver).__name__}"
        f" operator_complexity {oc!r}")
    log(f"3-D formats (A, P, R) {fmt} smoothers {[type(L.pre).__name__ for L in h.levels]}")
    log(f"3-D setup_s {t1 - t0!r} lowering_s {t2 - t1!r}")
    if rows != N3_ROWS or ml.final_A.shape != (N3_COARSE, N3_COARSE) or h.coarse.kind != "qr":
        raise AssertionError(f"3-D levels {rows} + {ml.final_A.shape} {h.coarse.kind}, not {N3_ROWS} + an 8-row QR")
    if abs(oc - N3_OC) > 1e-4:
        raise AssertionError(f"3-D operator complexity {oc} != {N3_OC}")
    L0 = h.levels[0]
    if fmt[0] != ("LatND", "LatND", "LatND") or len(L0.A.offsets) != 7:
        raise AssertionError(f"L0 is {fmt[0]} with {len(L0.A.offsets)} offsets, not a 7-offset LatND")
    for c in (L0.pre, L0.post):
        if not (isinstance(c, Sweep3DCache) and c.n_colors == 2 and c.steps == (0, 1, 0)):
            raise AssertionError(f"L0 smoother {c!r} is not K7 with 2 colors and steps (0, 1, 0)")
        if c.march is None:
            raise AssertionError(f"L0's K7 has no march plan (tile box {c.box})")
    if fmt[1:] != N3_FORMATS:
        raise AssertionError(f"L1-L4 lowered to {fmt[1:]}, not {N3_FORMATS}")

    # K7 against its plain version: L0 (timed) and an odd grid
    gen = torch.Generator(device="cpu").manual_seed(3)
    n0, pad0 = L0.A.shape[0], L0.A.rows_padded

    def vec(m, length, dtype):
        v = torch.zeros(length, dtype=dtype)
        v[:m] = torch.randn(m, generator=gen, dtype=dtype)
        return v.to(device)

    rows_k7 = []
    x, b = vec(n0, pad0, torch.float32), vec(n0, pad0, torch.float32)
    for c in (L0.pre, L0.post):
        rows_k7.append(compare_sweep("sweep3d", smooth_sweep3d, smooth_sweep3d_reference, c, x, b, "L0",
                                     timed=c is L0.pre, tile=True))
    del x, b
    prob = amt.poisson(ODD3, lattice=True)
    tab, nc = lattice_coloring_nd(prob.spec)
    for dtype in (torch.float32, torch.float64):
        A = latnd_from_spec(prob.spec, dtype, device)
        dinv = torch.zeros(A.rows_padded, dtype=dtype)
        dinv[: A.shape[0]] = torch.as_tensor(1.0 / prob.spec.diagonal(), dtype=dtype)
        x, b = vec(A.shape[0], A.rows_padded, dtype), vec(A.shape[0], A.rows_padded, dtype)
        for it, fwd, bwd, omega in ((1, True, True, 1.0), (1, True, False, 1.0), (2, True, True, 1.3)):
            c = build_sweep3d_cache(A, dinv.to(device), tab, nc, omega, it, fwd, bwd)
            rows_k7.append(compare_sweep("sweep3d", smooth_sweep3d, smooth_sweep3d_reference, c, x, b,
                                         "odd", timed=False, tile=True))

    # the solves, with the counters zeroed just before
    bh = np.random.default_rng(4).standard_normal(n0)
    A64 = _get_fine_f64(ml, device)
    b64 = torch.as_tensor(np.pad(bh, (0, A64.rows_padded - n0)), device=device)
    normb = float(torch.linalg.norm(b64))

    def relres(xv):
        xp = torch.zeros_like(b64)
        xp[:n0] = torch.as_tensor(xv, dtype=torch.float64, device=device)
        return float(torch.linalg.norm(b64 - mat_vec(A64, xp)) / normb)

    torch.cuda.synchronize()
    zero_counts()
    t3 = time.perf_counter()
    x_cg, iters, normr = amt.cg_device(ml, bh, tol=U_CG_TOL, device=device, dtype=torch.float32, log=True)
    t4 = time.perf_counter()
    stats = {}
    x_ref, hist = amt.solve_refined(ml, bh, tol=TOL, max_rounds=MAX_ROUNDS, device=device, log=True, stats=stats)
    t5 = time.perf_counter()
    counts = read_counts()
    rr_cg, rr_ref = relres(x_cg), relres(x_ref)
    log(f"3-D cg_device: {iters} iterations, its own relres {normr / normb!r}, f64 LatND relres {rr_cg!r},"
        f" {t4 - t3!r} s")
    log(f"3-D solve_refined: rounds {len(hist) - 1} pcg_iters_per_round {stats['inner_iters']} relres {rr_ref!r}"
        f" history {hist} {t5 - t4!r} s")
    log(f"launches in the 3-D solves {counts}")

    want_bsg, _ = expected_vcycle_launches(h)
    bv = torch.zeros(pad0, device=device)
    bv[:n0] = torch.as_tensor(bh, dtype=torch.float32, device=device)
    xv = torch.zeros_like(bv)
    torch.cuda.synchronize()
    zero_counts()
    _one_iteration(h, amt.V(), xv, bv)
    torch.cuda.synchronize()
    per_cycle = read_counts()
    vcycle_ms = time_ms(lambda: _one_iteration(h, amt.V(), xv, bv), reps=10)
    h_plain = amt.build_device_hierarchy(ml, device=device, dtype=torch.float32, sweeps=False)
    plain_vcycle_ms = time_ms(lambda: _one_iteration(h_plain, amt.V(), xv, bv), reps=10)
    del h_plain
    log(f"3-D vcycle_ms kernels {vcycle_ms!r} masked sweeps {plain_vcycle_ms!r}; launches per V-cycle"
        f" {per_cycle}; expected sweep3d 2 bsg {want_bsg}")

    for name, xs in (("cg_device", x_cg), ("solve_refined", x_ref)):
        if not (xs.shape == (n0,) and np.isfinite(xs).all()):
            raise AssertionError(f"3-D {name}: the solution is not a finite vector of the problem's size")
    if not (normr / normb < U_CG_TOL and rr_cg < U_CG_TRUE):
        raise AssertionError(f"3-D cg_device relres {normr / normb} (f64 LatND: {rr_cg})")
    if not (rr_ref < TOL and len(hist) - 1 <= MAX_ROUNDS):
        raise AssertionError(f"3-D solve_refined relres {rr_ref} after {len(hist) - 1} rounds")
    if not (counts["sweep3d"] > 0 and counts["bsg"] > 0):
        raise AssertionError(f"the 3-D solves did not launch K7 and K6: {counts}")
    want = dict.fromkeys(per_cycle, 0)
    want.update(sweep3d=2, bsg=want_bsg)
    if per_cycle != want:
        raise AssertionError(f"3-D V-cycle launches {per_cycle} != {want}")
    return rows_k7, counts, per_cycle, vcycle_ms, ml, iters


def lattice_fwd_bwd(device):
    """Phase 11: the 4096² flagship with forward/backward GS, every Lat2D
    level on K5."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration
    from algebraicmultigrid_tpu_torch.ops.kernels.gs_sweep import GSSweepCache, smooth_gs, smooth_gs_reference
    from algebraicmultigrid_tpu_torch.ops.kernels.tiled_sweep import plan_march
    from algebraicmultigrid_tpu_torch.ops.lattice_op import Lat2D

    t0 = time.perf_counter()
    ml = setup(
        N, presmoother=amt.GaussSeidel(ordering="multicolor", sweep=amt.ForwardSweep()),
        postsmoother=amt.GaussSeidel(ordering="multicolor", sweep=amt.BackwardSweep()),
    )
    t1 = time.perf_counter()
    h = amt.get_device_hierarchy(ml, device=device, dtype=torch.float32)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    levels = len(ml.levels) + 1
    lat = [i for i, L in enumerate(h.levels) if isinstance(L.A, Lat2D)]
    k5 = [i for i, L in enumerate(h.levels) if isinstance(L.pre, GSSweepCache) and isinstance(L.post, GSSweepCache)]
    log(f"fwd/bwd {N}x{N}: levels {levels} dims {[L.A.row_dims for L in h.levels]} tail_start {h.tail_start}"
        f" legs {[L.fused is not None for L in h.levels]} K5 levels {k5}; setup_s {t1 - t0!r} lowering_s {t2 - t1!r}")
    if levels != FB_LEVELS or h.tail is not None or any(L.fused is not None for L in h.levels):
        raise AssertionError(f"fwd/bwd: {levels} levels, tail {h.tail_start}, legs on some level")
    if not lat or k5 != lat:
        raise AssertionError(f"K5 on levels {k5}, the Lat2D levels are {lat}")
    if h.levels[0].pre.steps != (0, 1) or h.levels[0].post.steps != (1, 0):
        raise AssertionError(f"L0 steps {h.levels[0].pre.steps} / {h.levels[0].post.steps}")
    for lvl in lat:
        L = h.levels[lvl]
        for c in (L.pre, L.post):
            planned, why = plan_march(c.dims, c.offsets, len(c.steps), 4, device=device)
            if c.dims != (L.A.row_dims[0], 1, L.A.row_dims[1]) or c.box is not None or c.march != planned:
                raise AssertionError(f"L{lvl}'s K5 is not on its planned march {planned} ({why}): {c.dims} {c.march}")

    gen = torch.Generator(device="cpu").manual_seed(5)
    rows_k5 = []
    for lvl in lat:
        L = h.levels[lvl]
        n, pad = L.A.shape[0], L.A.rows_padded
        x = torch.zeros(pad)
        b = torch.zeros(pad)
        x[:n], b[:n] = torch.randn(n, generator=gen), torch.randn(n, generator=gen)
        x, b = x.to(device), b.to(device)
        for c in (L.pre, L.post):
            rows_k5.append(compare_sweep("gs_sweep", smooth_gs, smooth_gs_reference, c, x, b, f"L{lvl}", tile=True))

    bh = np.random.default_rng(6).standard_normal(N * N)
    torch.cuda.synchronize()
    zero_counts()
    t3 = time.perf_counter()
    stats = {}
    x, hist = amt.solve_refined(ml, bh, tol=TOL, max_rounds=MAX_ROUNDS, device=device, log=True, stats=stats)
    t4 = time.perf_counter()
    counts = read_counts()
    relres = float(np.linalg.norm(bh - ml.levels[0].A @ x) / np.linalg.norm(bh))
    log(f"fwd/bwd solve_refined: rounds {len(hist) - 1} pcg_iters_per_round {stats['inner_iters']}"
        f" relres {relres!r} history {hist} {t4 - t3!r} s; launches {counts}")

    bv = torch.zeros(h.fine_padded, device=device)
    bv[: N * N] = torch.as_tensor(bh, dtype=torch.float32, device=device)
    xv = torch.zeros_like(bv)
    torch.cuda.synchronize()
    zero_counts()
    _one_iteration(h, amt.V(), xv, bv)
    torch.cuda.synchronize()
    per_cycle = read_counts()
    per_level = read_level_counts().get("gs", {})
    vcycle_ms = time_ms(lambda: _one_iteration(h, amt.V(), xv, bv), reps=10)
    h_plain = amt.build_device_hierarchy(ml, device=device, dtype=torch.float32, sweeps=False)
    plain_vcycle_ms = time_ms(lambda: _one_iteration(h_plain, amt.V(), xv, bv), reps=10)
    del h_plain
    log(f"fwd/bwd vcycle_ms kernels {vcycle_ms!r} masked sweeps {plain_vcycle_ms!r};"
        f" launches per V-cycle {per_cycle}; K5 by level {per_level}")
    for r in rows_k5:
        r["launches_per_vcycle"] = per_level.get("x".join(str(d) for d in r["dims"]), 0)

    if not (x.shape == (N * N,) and np.isfinite(x).all()):
        raise AssertionError("fwd/bwd: the solution is not a finite vector of the problem's size")
    if not (relres < TOL and len(hist) - 1 <= MAX_ROUNDS):
        raise AssertionError(f"fwd/bwd solve_refined relres {relres} after {len(hist) - 1} rounds")
    if not counts["gs"] > 0:
        raise AssertionError(f"the fwd/bwd solve did not launch K5: {counts}")
    want = dict.fromkeys(per_cycle, 0)
    want["gs"] = FB_K5_PER_VCYCLE
    if per_cycle != want:
        raise AssertionError(f"fwd/bwd V-cycle launches {per_cycle} != {want}")
    if any(r["launches_per_vcycle"] != 2 for r in rows_k5):
        raise AssertionError(f"K5 launches by level {per_level}: not 2 (pre, post) on every Lat2D level")
    return rows_k5, counts, per_cycle, vcycle_ms


# --------------------------------------------------------------------------
# the phased whole-subcycle path (phase 12)
# --------------------------------------------------------------------------

EXPECT_SUB_START = 1  # the JAX package's at 4096²: the level above the tail
SUB_RTOL = {"float32": KERNEL_RTOL, "float64": 1e-12}
SUB_SMALL_TAIL_ROWS = 600  # the 192² problem's tail at L2, its sub level L1 (64²)
SUB_ROUTE_TAIL_ROWS = 2_500_000  # K4 entered at L1: the one-launch route without tiles


def sub_work(cache):
    """(words, flops) of one whole-subcycle call: level t's planes, D⁻¹, T,
    S (each at its own itemsize, ``plane_words``) and b read once and x
    written once, the tail's planes and Mc read once
    (b_c, x_c and x_mid never leave the kernel's buffers); the flops of the
    down leg from zero, the tail and the up leg."""
    top = cache.top
    n = top.row_dims[0] * top.row_dims[1]
    n0 = cache.tail.levels[0].row_dims[0] * cache.tail.levels[0].row_dims[1]
    t_words, t_flops = tail_work(cache.tail, True)
    words = plane_words(top) + 2 * n + t_words - 2 * n0
    flops = (leg_work(top, top.steps, False, True, x_zero=True)[1] + t_flops
             + leg_work(top, top.steps, True, False)[1])
    return words, flops


def compare_subcycle(cache, b, where):
    """K9 against its plain version on one b; (max abs, max rel) error."""
    import torch

    from algebraicmultigrid_tpu_torch.ops.kernels import subcycle_kernel as sk

    got, ref = sk.fused_subcycle(cache, b), sk.fused_subcycle_reference(cache, b)
    torch.cuda.synchronize()
    abs_err, rel_err = errors(got, ref)
    key = str(b.dtype).removeprefix("torch.")
    log(f"kernel fused_subcycle {where} {cache.top.row_dims} {key} tiles {cache.tiles}:"
        f" max_rel_err {rel_err!r} max_abs_err {abs_err!r}")
    if not rel_err <= SUB_RTOL[key]:
        raise AssertionError(f"fused_subcycle {where} {key} disagrees with its plain version: {rel_err}")
    return got, abs_err


def subcycle_path(device, ml):
    """Phase 12: the 4096² flagship with the subcycle: K9 against its plain
    version and the routes it replaces, the refined solve and the
    fixed-cycle loop with the counters zeroed just before each."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _cycle, _one_iteration, run_fixed_cycles
    from algebraicmultigrid_tpu_torch.ops.kernels import subcycle_kernel as sk
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk

    t0 = time.perf_counter()
    h = amt.get_device_hierarchy(ml, device=device, dtype=torch.float32, subcycle=True)
    torch.cuda.synchronize()
    log(f"subcycle {N}x{N}: tail_start {h.tail_start} sub_start {h.sub_start} tiles {h.sub and h.sub.tiles}"
        f" lowering_s {time.perf_counter() - t0!r}")
    if (h.sub_start, h.tail_start) != (EXPECT_SUB_START, EXPECT_TAIL_START) or h.sub.top is not h.levels[1].fused:
        raise AssertionError(f"sub_start {h.sub_start}, tail_start {h.tail_start}: not"
                             f" {EXPECT_SUB_START} and {EXPECT_TAIL_START} with L1's legs")

    gen = torch.Generator(device="cpu").manual_seed(7)
    L1 = h.levels[1]
    n1, pad1 = L1.A.shape[0], L1.A.rows_padded

    def vec(m, length, dtype=torch.float32):
        v = torch.zeros(length, dtype=dtype)
        v[:m] = torch.randn(m, generator=gen, dtype=dtype)
        return v.to(device)

    # K9 at L1, float32 (timed) and float64, against its plain version
    b = vec(n1, pad1)
    x_sub, abs32 = compare_subcycle(h.sub, b, "L1")
    row = dict(level=1, dims=h.sub.top.row_dims, tile=h.sub.tiles[0], max_abs_err=abs32,
               ms=time_ms(lambda: sk.fused_subcycle(h.sub, b)),
               plain_ms=time_ms(lambda: sk.fused_subcycle_reference(h.sub, b)))
    row["bound_ms"], row["bound_by"] = bound(*sub_work(h.sub), 4)
    sub64 = sk.build_fused_subcycle_cache(ml.levels, ml, EXPECT_SUB_START, torch.float64, device)
    _, abs64 = compare_subcycle(sub64, vec(n1, pad1, torch.float64), "L1")
    del sub64

    # the routes K9 replaces, on the same b: the L1 legs + K4, and K4 from L1
    h_legs = amt.build_device_hierarchy(ml, device=device, dtype=torch.float32)
    h_t1 = amt.build_device_hierarchy(ml, device=device, dtype=torch.float32, tail_max_rows=SUB_ROUTE_TAIL_ROWS)
    if h_legs.sub is not None or h_legs.tail_start != EXPECT_TAIL_START or h_t1.tail_start != 1:
        raise AssertionError(f"routes: tail_start {h_legs.tail_start} and {h_t1.tail_start}, not 2 and 1")
    z = torch.zeros_like(b)
    routes = {
        "route_ms": lambda: _cycle(h_legs, amt.V(), z, b, 1, x_zero=True),
        "tail_at_l1_ms": lambda: tk.fused_tail(h_t1.tail, z, b, x_zero=True),
    }
    for key, fn in routes.items():
        rel = errors(fn(), x_sub)[1]
        row[key] = time_ms(fn)
        log(f"subcycle route {key}: {row[key]!r} ms, max_rel_err against K9 {rel!r}")
        if not rel <= KERNEL_RTOL:
            raise AssertionError(f"{key} disagrees with K9: {rel}")
    del h_t1
    log(f"kernel fused_subcycle L1 {row['dims']}: kernel {row['ms']!r} ms"
        f" (first design, recorded: {FIRST_DESIGN_MS['fused_subcycle', 1]!r} ms) plain {row['plain_ms']!r} ms"
        f" legs+K4 {row['route_ms']!r} ms K4 from L1 {row['tail_at_l1_ms']!r} ms"
        f" bound {row['bound_ms']!r} ms ({row['bound_by']})")

    # the 192² problem: a second size, its L1 (64²) within one block and a
    # clipped coarse edge
    ml_s = setup(SMALL, proxy=64, cut_rows=2000, min_proxy_dim=16)
    abs_small = []
    for dtype in (torch.float32, torch.float64):
        hs = amt.build_device_hierarchy(ml_s, device=device, dtype=dtype, tail_max_rows=SUB_SMALL_TAIL_ROWS,
                                        subcycle=True)
        if (hs.sub_start, hs.tail_start) != (1, 2):
            raise AssertionError(f"{SMALL}²: sub_start {hs.sub_start}, tail_start {hs.tail_start}")
        Ls = hs.levels[1]
        abs_small.append(compare_subcycle(hs.sub, vec(Ls.A.shape[0], Ls.A.rows_padded, dtype), f"{SMALL}² L1")[1])
    row["max_abs_err"] = max(abs32, abs64, *abs_small)

    # the refined solve, then the fixed-cycle loop, counters zeroed before each
    bh = np.random.default_rng(8).standard_normal(N * N)
    torch.cuda.synchronize()
    zero_counts()
    t1 = time.perf_counter()
    stats = {}
    x, hist = amt.solve_refined(ml, bh, tol=TOL, max_rounds=MAX_ROUNDS, device=device, log=True, stats=stats,
                                subcycle=True)
    t2 = time.perf_counter()
    solve_counts = read_counts()
    relres = float(np.linalg.norm(bh - ml.levels[0].A @ x) / np.linalg.norm(bh))
    log(f"subcycle solve_refined: rounds {len(hist) - 1} pcg_iters_per_round {stats['inner_iters']}"
        f" relres {relres!r} history {hist} {t2 - t1!r} s; launches {solve_counts}")

    bf = torch.zeros(h.fine_padded, device=device)
    bf[: N * N] = torch.as_tensor(ml.levels[0].A @ np.ones(N * N), dtype=torch.float32, device=device)
    xf = torch.zeros_like(bf)
    torch.cuda.synchronize()
    zero_counts()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    xc = run_fixed_cycles(h, xf, bf, CYCLES)
    stop.record()
    torch.cuda.synchronize()
    cycle_counts = read_counts()
    fixed_ms = start.elapsed_time(stop) / CYCLES
    xch = xc[: N * N].double().cpu().numpy()
    relres_fixed = float(np.linalg.norm(bf[: N * N].double().cpu().numpy() - ml.levels[0].A @ xch)
                         / float(bf.double().norm()))
    log(f"subcycle fixed cycles {CYCLES}: ms_per_cycle {fixed_ms!r} relres_after_cycles {relres_fixed!r};"
        f" launches {cycle_counts}")

    # a V-cycle and a fixed cycle with and without the subcycle, in turns
    times = {"vcycle_legs": [], "vcycle_sub": [], "fixed_legs": [], "fixed_sub": []}
    for hh, tag in ((h_legs, "legs"), (h, "sub"), (h, "sub"), (h_legs, "legs")):
        times[f"vcycle_{tag}"].append(time_ms(lambda: _one_iteration(hh, amt.V(), xf, bf), reps=10))
        times[f"fixed_{tag}"].append(time_ms(lambda: run_fixed_cycles(hh, xf, bf, 50), reps=2) / 50)
    del h_legs
    log(f"subcycle timings in turns (legs, sub, sub, legs): {times}")
    row.update(vcycle_ms=times["vcycle_sub"][0], vcycle_legs_ms=times["vcycle_legs"][0],
               fixed_ms=times["fixed_sub"][0], fixed_legs_ms=times["fixed_legs"][0])

    if not (x.shape == (N * N,) and np.isfinite(x).all()):
        raise AssertionError("subcycle: the solution is not a finite vector of the problem's size")
    if not (relres < TOL and len(hist) - 1 <= MAX_ROUNDS):
        raise AssertionError(f"subcycle solve_refined relres {relres} after {len(hist) - 1} rounds")
    c = solve_counts
    if not (c["sub"] > 0 and c["tail"] == 0 and c["down"] == c["up"] == c["sub"] and c["updown"] == 0):
        raise AssertionError(f"the subcycle solve's launches {c}: K9 once per V-cycle, K1/K2 only at L0, no K4")
    if not (np.isfinite(xch).all() and relres_fixed < CYCLES_RELRES):
        raise AssertionError(f"subcycle relres_after_cycles {relres_fixed} >= {CYCLES_RELRES}")
    want = dict.fromkeys(cycle_counts, 0)
    want.update(updown=CYCLES - 1, sub=CYCLES, down=1, up=1)
    if cycle_counts != want:
        raise AssertionError(f"subcycle fixed-cycle launches {cycle_counts} != {want}")
    return row, solve_counts, cycle_counts


def subcycle_bf16_path(device, ml):
    """Phase 19: the flagship lowered with the subcycle and bf16 planes in
    float32 and float64; K9's ``f32_bf16``/``f64_bf16`` entries against
    their plain version and timed in turns with K9 on the vectors' own
    planes; the refined solve and the fixed-cycle loop (float32) with the
    counters zeroed just before each.  Returns {entry: row}."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import run_fixed_cycles
    from algebraicmultigrid_tpu_torch.ops.kernels import subcycle_kernel as sk

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cpu").manual_seed(19)

    def vec(m, length, dtype):
        v = torch.zeros(length, dtype=dtype)
        v[:m] = torch.randn(m, generator=gen, dtype=dtype)
        return v.to(device)

    rows = {}
    ml_s = setup(SMALL, proxy=64, cut_rows=2000, min_proxy_dim=16)
    for dtype in (torch.float32, torch.float64):
        key = str(dtype).removeprefix("torch.")
        entry = BF16_SUFFIX[key]
        t0 = time.perf_counter()
        h = amt.get_device_hierarchy(ml, device=device, dtype=dtype, subcycle=True, coef_dtype=bf16)
        torch.cuda.synchronize()
        log(f"subcycle bf16 planes, {key} vectors, {N}x{N}: tail_start {h.tail_start} sub_start {h.sub_start}"
            f" tiles {h.sub and h.sub.tiles} lowering_s {time.perf_counter() - t0!r}")
        if (h.sub_start, h.tail_start) != (EXPECT_SUB_START, EXPECT_TAIL_START):
            raise AssertionError(f"bf16 {key}: sub_start {h.sub_start}, tail_start {h.tail_start}")
        if not all((L.A.dtype, L.T.dtype, L.S.dtype, L.dinv.dtype, L.dtype) == (bf16,) * 3 + (dtype, dtype)
                   for L in h.sub.levels) or h.sub.tail.Mc.dtype != dtype:
            raise AssertionError(f"bf16 {key}: the subcycle's A, T, S are not bf16 with D⁻¹ and Mc in {key}")
        f0 = h.levels[0].fused
        if (f0.A.dtype, f0.dinv.dtype) != (bf16, bf16) or h.sub.top is h.levels[1].fused:
            raise AssertionError(f"bf16 {key}: L0's legs are not the legs' bf16 cache, or L1's legs were reused")
        if not all(L.A.data.dtype == dtype for L in h.levels):
            raise AssertionError(f"bf16 {key}: a level's own operator is not {key}")

        L1 = h.levels[1]
        b = vec(L1.A.shape[0], L1.A.rows_padded, dtype)
        _, abs_err = compare_subcycle(h.sub, b, "L1 bf16 planes")
        hs = amt.build_device_hierarchy(ml_s, device=device, dtype=dtype, tail_max_rows=SUB_SMALL_TAIL_ROWS,
                                        subcycle=True, coef_dtype=bf16)
        if (hs.sub_start, hs.tail_start) != (1, 2):
            raise AssertionError(f"{SMALL}² bf16: sub_start {hs.sub_start}, tail_start {hs.tail_start}")
        Ls = hs.levels[1]
        abs_err = max(abs_err, compare_subcycle(hs.sub, vec(Ls.A.shape[0], Ls.A.rows_padded, dtype),
                                                f"{SMALL}² L1 bf16 planes")[1])
        own = sk.build_fused_subcycle_cache(ml.levels, ml, EXPECT_SUB_START, dtype, device)
        tag = {"float32": "f32", "float64": "f64"}[key]
        row = dict(entry=entry, level=1, dims=h.sub.top.row_dims, max_abs_err=abs_err)
        row[f"{tag}_ms"], row["ms"], row["turns_ms"] = in_turns(lambda: sk.fused_subcycle(own, b),
                                                                lambda: sk.fused_subcycle(h.sub, b))
        row["plain_ms"] = time_ms(lambda: sk.fused_subcycle_reference(h.sub, b))
        row["bound_ms"], row["bound_by"] = bound(*sub_work(h.sub), dtype.itemsize,
                                                 F32_FLOPS if key == "float32" else F64_FLOPS)
        row[f"{tag}_bound_ms"] = bound(*sub_work(own), dtype.itemsize,
                                       F32_FLOPS if key == "float32" else F64_FLOPS)[0]
        del own
        log(f"kernel fused_subcycle_{entry} L1 {row['dims']}: kernel {row['ms']!r} ms, {key} planes in turns"
            f" {row[f'{tag}_ms']!r} ms ({tag}/bf16/bf16/{tag} {row['turns_ms']}) plain {row['plain_ms']!r} ms"
            f" bound {row['bound_ms']!r} ms ({row['bound_by']}, 2-byte planes; {key} planes"
            f" {row[f'{tag}_bound_ms']!r})")

        if key == "float32":
            bh = np.random.default_rng(19).standard_normal(N * N)
            torch.cuda.synchronize()
            zero_counts()
            t1 = time.perf_counter()
            stats = {}
            x, hist = amt.solve_refined(ml, bh, tol=TOL, max_rounds=MAX_ROUNDS, device=device, log=True,
                                        stats=stats, subcycle=True, coef_dtype=bf16)
            t2 = time.perf_counter()
            c = read_counts()
            relres = float(np.linalg.norm(bh - ml.levels[0].A @ x) / np.linalg.norm(bh))
            log(f"subcycle bf16 solve_refined: rounds {len(hist) - 1} pcg_iters_per_round {stats['inner_iters']}"
                f" relres {relres!r} history {hist} {t2 - t1!r} s; launches {c}")
            if not (np.isfinite(x).all() and relres < TOL and len(hist) - 1 <= MAX_ROUNDS):
                raise AssertionError(f"subcycle bf16 solve_refined relres {relres} after {len(hist) - 1} rounds")
            if not (c["sub"] > 0 and c["tail"] == 0 and c["down"] == c["up"] == c["sub"] and c["updown"] == 0):
                raise AssertionError(f"the bf16 subcycle solve's launches {c}: K9 per V-cycle, K1/K2 at L0 only")
            row["launches_solve"] = c["sub"]

            bf = torch.zeros(h.fine_padded, device=device)
            bf[: N * N] = torch.as_tensor(ml.levels[0].A @ np.ones(N * N), dtype=torch.float32, device=device)
            torch.cuda.synchronize()
            zero_counts()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            xc = run_fixed_cycles(h, torch.zeros_like(bf), bf, CYCLES)
            stop.record()
            torch.cuda.synchronize()
            cycle_counts = read_counts()
            row["fixed_ms"] = start.elapsed_time(stop) / CYCLES
            xch = xc[: N * N].double().cpu().numpy()
            relres_fixed = float(np.linalg.norm(bf[: N * N].double().cpu().numpy() - ml.levels[0].A @ xch)
                                 / float(bf.double().norm()))
            log(f"subcycle bf16 fixed cycles {CYCLES}: ms_per_cycle {row['fixed_ms']!r} relres_after_cycles"
                f" {relres_fixed!r}; launches {cycle_counts}")
            want = dict.fromkeys(cycle_counts, 0)
            want.update(updown=CYCLES - 1, sub=CYCLES, down=1, up=1)
            if not (np.isfinite(xch).all() and relres_fixed < CYCLES_RELRES) or cycle_counts != want:
                raise AssertionError(f"subcycle bf16 fixed cycles: relres {relres_fixed}, launches {cycle_counts}"
                                     f" != {want}")
            row["launches"] = cycle_counts["sub"]
        else:
            # float64: one V-cycle with the counters zeroed (K1/K2 at L0, K9)
            from algebraicmultigrid_tpu_torch.models.device import _one_iteration

            bf = vec(N * N, h.fine_padded, dtype)
            torch.cuda.synchronize()
            zero_counts()
            _one_iteration(h, amt.V(), torch.zeros_like(bf), bf)
            torch.cuda.synchronize()
            c = read_counts()
            want = dict.fromkeys(c, 0)
            want.update(down=1, up=1, sub=1)
            if c != want:
                raise AssertionError(f"subcycle f64 bf16 V-cycle launches {c} != {want}")
            row["launches"] = c["sub"]
        rows[entry] = row
        del h
        ml._device_cache.clear()
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# the slab-sharded tier and K8 (phase 13)
# --------------------------------------------------------------------------

SLAB_RANKS = 4
SLAB_TIMEOUT_S = 900
HALO_CALLS = 5  # K8 calls per rank on the main path, 2 launches each
HALO_RTOL = {"float32": 1e-6, "float64": 1e-14}
HALO_COARSE_LEVEL = 2  # the flagship's L2, 456² with the 9-point stencil
SLAB_CYCLE_RTOL = 2e-5  # 4 slabs against 1: the JAX test's shard-invariance bound
SLAB_DEVICE_RTOL = 2e-4  # against the single-card masked-sweep cycle, as the JAX test
SLAB_SOLVE_TOL = 1e-6
# scipy's f64 check of the f32 answer: its rounding floor (ROADMAP C), not 1e-8
SLAB_SOLVE_TRUE = 1e-4


def halo_specs(ml, n_sh):
    """The K8 cases: the flagship's fine operator (4096², 5-point), a grid
    of 2·n_sh × 77 (slabs of exactly 2·reach rows, a width no multiple of
    32) and the flagship's L2 (9-point)."""
    import algebraicmultigrid_tpu_torch as amt

    return {
        "fine": ml.levels[0].A.spec,
        "thin": amt.poisson((77, 2 * n_sh), lattice=True).spec,
        "coarse": ml.levels[HALO_COARSE_LEVEL].A.spec,
    }


def halo_x(spec, dtype):
    """The case's x over the whole grid: standard normal from seed 0."""
    import torch

    Wx, Wy = spec.row_dims
    return torch.as_tensor(np.random.default_rng(0).standard_normal(Wx * Wy), dtype=getattr(torch, dtype))


def slab_rhs(h, seed=0):
    """A standard-normal b on the true fine grid, zero on the padding."""
    Wx, Wy = h.fine_dims
    b = np.zeros(h.fine_pdims, dtype=np.float32)
    b[:Wx, :Wy] = np.random.default_rng(seed).standard_normal((Wx, Wy))
    return b


def slab_rank(mesh):
    """Phase 13 on one rank: the flagship's setup and slab hierarchy, K8
    through ``lat2d_spmv_halo(overlap=True)`` with the counters zeroed just
    before (the main path), K8 against its plain version on the same halo
    and against ``overlap=False`` in every case, its time with the ranks
    sharing the card, the slab V-cycle from zero and the sharded solve."""
    import torch

    from algebraicmultigrid_tpu_torch.ops.kernels.halo_stencil import halo_stencil_reference
    from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec
    from algebraicmultigrid_tpu_torch.parallel import cycle_lattice_sharded, lat2d_spmv_halo, shard_slab, solve_lattice_sharded
    from algebraicmultigrid_tpu_torch.parallel.halo import exchange_rows, slab_operator
    from algebraicmultigrid_tpu_torch.parallel.lattice_cycle import slab_hierarchy

    out = {}
    t0 = time.perf_counter()
    ml = setup(N)
    t1 = time.perf_counter()
    h = slab_hierarchy(ml, mesh)
    torch.cuda.synchronize()
    out["setup_s"], out["slab_build_s"] = t1 - t0, time.perf_counter() - t1
    specs = halo_specs(ml, mesh.n_sh)

    A = lat2d_from_spec(specs["fine"], torch.float32, mesh.device, row_pad=8)
    Wx, Wy = A.row_dims
    xs = shard_slab(halo_x(specs["fine"], "float32"), mesh, Wx, Wy)
    zero_counts()
    for _ in range(HALO_CALLS):
        y = lat2d_spmv_halo(A, xs, mesh, overlap=True)
    torch.cuda.synchronize()
    out["counts"] = read_counts()
    out["halo_shared_ms"] = time_ms(lambda: lat2d_spmv_halo(A, xs, mesh, overlap=True))
    del A, xs, y

    out["halo"] = {}
    for name, spec in specs.items():
        for dtype in ("float32", "float64"):
            A = lat2d_from_spec(spec, getattr(torch, dtype), mesh.device, row_pad=8)
            Wx, Wy = A.row_dims
            xs = shard_slab(halo_x(spec, dtype), mesh, Wx, Wy)
            got = lat2d_spmv_halo(A, xs, mesh, overlap=True)
            data, loc, _, reach, _ = slab_operator(A, mesh)
            X = xs.reshape(loc, Wy)
            halo = torch.stack(exchange_rows(X[:reach], X[loc - reach :], mesh))
            ref = torch.empty_like(X)
            for part in ("interior", "boundary"):
                halo_stencil_reference(data, X, halo, A.offsets, part, ref)
            plain = lat2d_spmv_halo(A, xs, mesh)
            torch.cuda.synchronize()
            out["halo"][name, dtype] = dict(
                y=got.cpu().numpy(), loc=loc, Wy=Wy, n_off=len(A.offsets), plain_err=errors(got, ref.reshape(-1)),
                exchange_err=errors(got, plain),
            )
            del A, xs, got, ref, plain

    b = torch.as_tensor(slab_rhs(h), device=mesh.device)
    if h.levels[0].sharded:
        loc = h.fine_pdims[0] // mesh.n_sh
        b = b[mesh.rank * loc : (mesh.rank + 1) * loc]
    out["cycle"] = cycle_lattice_sharded(h, torch.zeros_like(b), b, mesh).cpu().numpy()
    A0 = ml.levels[0].A
    t2 = time.perf_counter()
    x, it, relres = solve_lattice_sharded(ml, A0 @ np.ones(A0.shape[0]), mesh=mesh, tol=SLAB_SOLVE_TOL,
                                          maxiter=100, log=True)
    out["solve_s"] = time.perf_counter() - t2
    out["solve"] = (x if mesh.rank == 0 else None, it, relres)
    out["pdims"] = [(lv.pdims, lv.sharded) for lv in h.levels]
    return out


def lat2d_csr(A):
    """The Lat2D operator as a CSR tensor on its device (for the library
    SpMV beside K8)."""
    import torch

    Wx, Wy = A.row_dims
    dev = A.data.device
    i = torch.arange(Wx, device=dev)[:, None].expand(Wx, Wy)
    j = torch.arange(Wy, device=dev)[None, :].expand(Wx, Wy)
    rows, cols, vals = [], [], []
    for k, (dx, dy) in enumerate(A.offsets):
        ok = (i + dx >= 0) & (i + dx < Wx) & (j + dy >= 0) & (j + dy < Wy)
        rows.append((i * Wy + j)[ok])
        cols.append(((i + dx) * Wy + j + dy)[ok])
        vals.append(A.data[k][ok])
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
                                  (Wx * Wy, Wx * Wy))
    return coo.coalesce().to_sparse_csr()


def check_slab_ranks(res, backend, ml, device):
    """Every rank's K8 checks, exact launch counts, and the cases' slabs
    gathered against the single-card SpMV of the whole grid; returns the
    largest K8 error against its plain version."""
    import torch

    from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec, lat2d_spmv

    worst = 0.0
    for rank, r in enumerate(res):
        log(f"slab rank {rank} ({backend}): setup_s {r['setup_s']!r} slab_build_s {r['slab_build_s']!r}"
            f" solve_s {r['solve_s']!r} launches on the main path {r['counts']}"
            f" K8 {r['halo_shared_ms']!r} ms with {len(res)} ranks sharing the card")
        want = dict.fromkeys(r["counts"], 0)
        want["halo"] = 2 * HALO_CALLS
        if r["counts"] != want:
            raise AssertionError(f"rank {rank}: {HALO_CALLS} overlapped SpMVs launched {r['counts']} != {want}")
        for (name, dtype), c in r["halo"].items():
            (pa, pr), (ea, er) = c["plain_err"], c["exchange_err"]
            log(f"kernel halo_stencil rank {rank} {name} slab {c['loc']}x{c['Wy']} offsets {c['n_off']} {dtype}:"
                f" max_rel_err {pr!r} max_abs_err {pa!r} against overlap=False {er!r}")
            if not (pr <= HALO_RTOL[dtype] and er <= HALO_RTOL[dtype]):
                raise AssertionError(f"rank {rank}: K8 {name} {dtype} disagrees: {pr} / {er}")
            worst = max(worst, pa)
    for (name, dtype) in res[0]["halo"]:
        spec = halo_specs(ml, len(res))[name]
        if name == "coarse" and len(spec.offsets) != 9:
            raise AssertionError(f"L{HALO_COARSE_LEVEL} has {len(spec.offsets)} offsets, not 9")
        A = lat2d_from_spec(spec, getattr(torch, dtype), device, row_pad=8)
        n = A.shape[0]
        whole = lat2d_spmv(A, halo_x(spec, dtype).to(device))[:n]
        got = torch.as_tensor(np.concatenate([r["halo"][name, dtype]["y"] for r in res]))
        e = errors(got, whole)
        log(f"slab SpMV {name} {dtype} ({backend}, {len(res)} ranks) against the single-card SpMV:"
            f" max_rel_err {e[1]!r}")
        if not e[1] <= HALO_RTOL[dtype]:
            raise AssertionError(f"{name} {dtype}: the sharded SpMV disagrees with the single-card one: {e}")
    return worst


def check_slab_solve(res, ml, it1, backend):
    """The 4-slab V-cycle against the one-slab and single-card ones and the
    sharded solve against its own tolerance, scipy's and n_sh = 1's
    iterations."""
    _, it, relres = res[0]["solve"]
    x = res[0]["solve"][0]
    A0 = ml.levels[0].A
    b = A0 @ np.ones(A0.shape[0])
    true = float(np.linalg.norm(b - A0 @ x) / np.linalg.norm(b))
    log(f"solve_lattice_sharded ({backend}, {len(res)} ranks): iterations {it} relres {relres!r}"
        f" scipy f64 relres {true!r}; one slab {it1} iterations")
    if not all(r["solve"][1] == it for r in res):
        raise AssertionError(f"the ranks disagree on the iterations: {[r['solve'][1] for r in res]}")
    if not (np.isfinite(x).all() and relres < SLAB_SOLVE_TOL and true < SLAB_SOLVE_TRUE and abs(it - it1) <= 1):
        raise AssertionError(f"sharded solve: {it} iterations (one slab {it1}), relres {relres}, scipy {true}")


def slab_path(device, ml):
    """Phase 13: 4 gloo ranks on the one card, K8 and the slab tier at
    4096², held against n_sh = 1 and the single-card engine in this
    process; K8 timed here on the whole grid; NCCL across cards when the
    machine has them."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels.halo_stencil import halo_stencil_reference
    from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec
    from algebraicmultigrid_tpu_torch.parallel import cycle_lattice_sharded, lat2d_spmv_halo, make_row_mesh, run_ranks
    from algebraicmultigrid_tpu_torch.parallel import solve_lattice_sharded
    from algebraicmultigrid_tpu_torch.parallel.lattice_cycle import slab_hierarchy

    t0 = time.perf_counter()
    res = run_ranks(slab_rank, SLAB_RANKS, backend="gloo", device=device, timeout_s=SLAB_TIMEOUT_S)
    log(f"slab tier: {SLAB_RANKS} gloo ranks on one card answered in {time.perf_counter() - t0!r} s;"
        f" levels (pdims, sharded) {res[0]['pdims']}")
    worst = check_slab_ranks(res, "gloo", ml, device)

    # n_sh = 1 in this process: the cycle, the single-card cycle, the solve
    mesh1 = make_row_mesh(device=device)
    h1 = slab_hierarchy(ml, mesh1)
    b = torch.as_tensor(slab_rhs(h1), device=device)
    x1 = cycle_lattice_sharded(h1, torch.zeros_like(b), b, mesh1).cpu().numpy()
    Wx, Wy = h1.fine_dims
    del h1
    x4 = np.concatenate([r["cycle"] for r in res])
    hd = build_device_hierarchy(ml, device=device, dtype=torch.float32, fused=False, tail=False, sweeps=False)
    bd = torch.zeros(hd.fine_padded, device=device)
    bd[: Wx * Wy] = b[:Wx, :Wy].reshape(-1)
    xd = _one_iteration(hd, amt.V(), torch.zeros_like(bd), bd)[: Wx * Wy].reshape(Wx, Wy).cpu().numpy()
    del hd, bd, b
    e1 = errors(torch.as_tensor(x4[:Wx, :Wy]), torch.as_tensor(x1[:Wx, :Wy]))[1]
    ed = errors(torch.as_tensor(x4[:Wx, :Wy]), torch.as_tensor(xd))[1]
    log(f"slab V-cycle from zero, {SLAB_RANKS} slabs: against one slab {e1!r}, against the single-card"
        f" masked-sweep cycle {ed!r}")
    if not (e1 <= SLAB_CYCLE_RTOL and ed <= SLAB_DEVICE_RTOL):
        raise AssertionError(f"slab V-cycle: {e1} against one slab, {ed} against the single-card cycle")
    A0 = ml.levels[0].A
    _, it1, rr1 = solve_lattice_sharded(ml, A0 @ np.ones(A0.shape[0]), mesh=mesh1, tol=SLAB_SOLVE_TOL,
                                        maxiter=100, log=True)
    log(f"solve_lattice_sharded (one slab): iterations {it1} relres {rr1!r}")
    check_slab_solve(res, ml, it1, "gloo")
    ml._device_cache.clear()
    torch.cuda.empty_cache()

    # K8 on the whole grid (no neighbours: interior + boundary, zero halo)
    A = lat2d_from_spec(ml.levels[0].A.spec, torch.float32, device, row_pad=8)
    x = halo_x(ml.levels[0].A.spec, "float32").to(device)
    n = A.shape[0]
    y = torch.empty((Wx, Wy), device=device)
    X = x.reshape(Wx, Wy)

    def plain():
        halo_stencil_reference(A.data, X, None, A.offsets, "interior", y)
        halo_stencil_reference(A.data, X, None, A.offsets, "boundary", y)

    got = lat2d_spmv_halo(A, x, mesh1, overlap=True)
    plain()
    torch.cuda.synchronize()
    abs_err, rel_err = errors(got, y.reshape(-1))
    S = lat2d_csr(A)
    xcol = x[:, None].contiguous()
    lib_err = errors(torch.sparse.mm(S, xcol)[:, 0], got)[1]
    row = dict(
        max_abs_err=max(worst, abs_err), ms=time_ms(lambda: lat2d_spmv_halo(A, x, mesh1, overlap=True)),
        plain_ms=time_ms(plain), library_ms=time_ms(lambda: torch.sparse.mm(S, xcol)),
        bound_ms=(len(A.offsets) + 2) * n * 4 / HBM_BYTES_S * 1e3, bound_by="bytes",
    )
    del S, xcol
    log(f"kernel halo_stencil one slab {Wx}x{Wy}: max_rel_err {rel_err!r} kernel {row['ms']!r} ms"
        f" plain {row['plain_ms']!r} ms torch.sparse.mm {row['library_ms']!r} ms (rel diff {lib_err!r})"
        f" bound {row['bound_ms']!r} ms (bytes)")
    if not rel_err <= HALO_RTOL["float32"]:
        raise AssertionError(f"K8 on one slab disagrees with its plain version: {rel_err}")
    row["launches"] = res[0]["counts"]["halo"]
    row["launches_per_rank"] = [r["counts"]["halo"] for r in res]
    row["shared_card_ms"] = [r["halo_shared_ms"] for r in res]
    del A, x, y, X, got
    torch.cuda.empty_cache()

    if torch.cuda.device_count() >= SLAB_RANKS:
        res_n = run_ranks(slab_rank, SLAB_RANKS, backend="nccl", timeout_s=SLAB_TIMEOUT_S)
        check_slab_ranks(res_n, "nccl", ml, device)
        check_slab_solve(res_n, ml, it1, "nccl")
        x4n = np.concatenate([r["cycle"] for r in res_n])
        en = errors(torch.as_tensor(x4n[:Wx, :Wy]), torch.as_tensor(x1[:Wx, :Wy]))[1]
        if not en <= SLAB_CYCLE_RTOL:
            raise AssertionError(f"nccl slab V-cycle against one slab: {en}")
        row["nccl"] = True
    else:
        log(f"NCCL across cards was not run on this machine: it has {torch.cuda.device_count()} card(s),"
            f" the phase needs {SLAB_RANKS}")
        row["nccl"] = False
    return row


# --------------------------------------------------------------------------
# the generic sharded tier (phase 20)
# --------------------------------------------------------------------------

SHARD_RANKS = 4
SHARD_TIMEOUT_S = 900
SHARD_RELTOL = 1e-5
SHARD_X_RTOL = 1e-5  # 4 ranks against 1, in the 2-norm
SHARD_RAP_RTOL = 5e-6  # the JAX test's bound on the probed planes
# the kernels that the sharded tier drops (legs, tail, subcycle)
SINGLE_CARD = ("down", "up", "updown", "tail", "sub", "down_nf", "up_nf", "tail_nf")


def unstructured_problem():
    """bench.py's scrambled 1024² Poisson (phase 7) and its SA hierarchy."""
    import scipy.sparse as sp

    import algebraicmultigrid_tpu_torch as amt

    A = sp.csr_matrix(amt.poisson((NU, NU)))
    p = np.random.default_rng(NU_SEED).permutation(A.shape[0])
    Ap = A[p][:, p].tocsr()
    return Ap, amt.smoothed_aggregation(Ap)


def layout(h):
    """(format of A, A held as a row block, smoother) by level."""
    from algebraicmultigrid_tpu_torch.parallel.rows import ShardedOp, ShardedSmoother

    return [(type(L.A.local if isinstance(L.A, ShardedOp) else L.A).__name__, isinstance(L.A, ShardedOp),
             type(L.pre.cache if isinstance(L.pre, ShardedSmoother) else L.pre).__name__
             + (" rows" if isinstance(L.pre, ShardedSmoother) else "")) for L in h.levels]


def sharded_times(h, device):
    """(L0 SpMV ms, V-cycle ms) of a sharded hierarchy by CUDA events (every
    rank calls it: the collectives pair up)."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration
    from algebraicmultigrid_tpu_torch.ops.banded import mat_vec

    x = torch.randn(h.fine_padded, generator=torch.Generator(device="cpu").manual_seed(20)).to(device)
    z = torch.zeros_like(x)
    return time_ms(lambda: mat_vec(h.levels[0].A, x), reps=5), time_ms(lambda: _one_iteration(h, amt.V(), z, x),
                                                                          reps=2)


def sharded_rank(mesh):
    """Phase 20 on one rank: (a) ``solve_sharded`` on the flagship with the
    counters zeroed just before, its layout and times; (c)
    ``rap_planes_sharded`` at L0 of the 4-slab hierarchy; (b)
    ``solve_sharded`` on the scrambled 1024² problem and one V-cycle of it
    with the counters zeroed just before."""
    import hashlib

    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, fit_len
    from algebraicmultigrid_tpu_torch.parallel import build_sharded_hierarchy, rap_planes_sharded, solve_sharded
    from algebraicmultigrid_tpu_torch.parallel.lattice_cycle import slab_hierarchy

    out = {}
    t0 = time.perf_counter()
    ml = setup(N)
    A0 = ml.levels[0].A
    b = A0 @ np.ones(A0.shape[0])
    t1 = time.perf_counter()
    zero_counts()
    x, it, nr = solve_sharded(ml, b, mesh=mesh, dtype="float32", reltol=SHARD_RELTOL)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out["counts"] = read_counts()
    out["solve"] = (x if mesh.rank == 0 else None, it, nr, hashlib.sha1(x.tobytes()).hexdigest())
    h = build_sharded_hierarchy(ml, mesh, dtype="float32")
    out["layout"] = layout(h)
    out["spmv_ms"], out["vcycle_ms"] = sharded_times(h, mesh.device)
    del h
    ml._device_cache.clear()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()

    hs = slab_hierarchy(ml, mesh)
    out["rap"] = rap_planes_sharded(hs, 0, mesh, ml.levels[1].A.spec.offsets).cpu().numpy()
    torch.cuda.synchronize()
    del hs
    ml._device_cache.clear()
    torch.cuda.empty_cache()
    t4 = time.perf_counter()

    Ap, mlu = unstructured_problem()
    bu = Ap @ np.ones(Ap.shape[0])
    xu, itu, nru = solve_sharded(mlu, bu, mesh=mesh, dtype="float32", reltol=SHARD_RELTOL)
    hu = build_sharded_hierarchy(mlu, mesh, dtype="float32")
    bp = fit_len(torch.as_tensor(bu, dtype=torch.float32, device=mesh.device), hu.fine_padded)
    torch.cuda.synchronize()
    zero_counts()
    _one_iteration(hu, amt.V(), torch.zeros_like(bp), bp)
    torch.cuda.synchronize()
    out["u_counts"] = read_counts()
    out["u_layout"] = layout(hu)
    out["u_solve"] = (itu, nru, float(np.linalg.norm(bu - Ap @ xu) / np.linalg.norm(bu)))
    del hu
    t5 = time.perf_counter()
    out["seconds"] = dict(setup=t1 - t0, flagship_solve=t2 - t1, flagship_times=t3 - t2, rap=t4 - t3,
                          unstructured=t5 - t4)
    return out


def check_sharded_ranks(res, backend, ml, it1, x1, u_bsg):
    """Every rank's phase 20 results against this process's n_sh = 1 runs."""
    x4 = res[0]["solve"][0]
    for rank, r in enumerate(res):
        _, it, nr, digest = r["solve"]
        log(f"sharded rank {rank} ({backend}): seconds {r['seconds']}; flagship solve {it} iterations"
            f" ‖r‖ {nr!r}, launches {r['counts']}; L0 SpMV {r['spmv_ms']!r} ms, V-cycle {r['vcycle_ms']!r} ms"
            f" with {len(res)} ranks sharing the card; unstructured (iterations, ‖r‖, scipy relres)"
            f" {r['u_solve']}, one V-cycle's launches {r['u_counts']}")
        if (it, digest) != (res[0]["solve"][1], res[0]["solve"][3]) or it != it1:
            raise AssertionError(f"rank {rank}: {it} iterations (n_sh = 1: {it1}), or another x than rank 0's")
        if any(r["counts"][k] for k in SINGLE_CARD) or any(r["u_counts"][k] for k in SINGLE_CARD):
            raise AssertionError(f"rank {rank}: the sharded tier launched a single-card kernel: {r['counts']}")
        if r["u_counts"]["bsg"] != u_bsg:
            raise AssertionError(f"rank {rank}: {r['u_counts']['bsg']} K6 launches a V-cycle, single card {u_bsg}")
        if not r["u_solve"][2] < 1e-4:
            raise AssertionError(f"rank {rank}: the unstructured sharded solve's scipy relres {r['u_solve'][2]}")
    log(f"sharded layout ({backend}; A's format, held in blocks, smoother): {res[0]['layout']};"
        f" unstructured {res[0]['u_layout']}")
    e = float(np.linalg.norm(x4 - x1) / np.linalg.norm(x1))
    log(f"solve_sharded ({backend}, {len(res)} ranks) x against n_sh = 1: {e!r} (2-norm)")
    if not (np.isfinite(x4).all() and e <= SHARD_X_RTOL):
        raise AssertionError(f"solve_sharded: x of {len(res)} ranks against one: {e}")
    if not res[0]["layout"][0][1]:
        raise AssertionError("the flagship's L0 is not held in row blocks")
    child = ml.levels[1].A.spec
    host = child.expand_all(dtype=np.float64)
    planes = np.concatenate([r["rap"] for r in res], axis=1)[:, : child.row_dims[0], : child.row_dims[1]]
    rap_err = float(np.abs(planes.astype(np.float64) - host).max() / np.abs(host).max())
    log(f"rap_planes_sharded ({backend}) at L0 of the {len(res)}-slab flagship: planes {planes.shape} against the"
        f" host child: max rel err {rap_err!r}")
    if not rap_err <= SHARD_RAP_RTOL:
        raise AssertionError(f"rap_planes_sharded disagrees with the host child: {rap_err}")
    return rap_err


def sharded_path(device, ml):
    """Phase 20: the generic sharded tier on 4 gloo ranks sharing the card
    (and NCCL, a card a rank, where the machine has 4), held against
    ``solve_sharded`` at n_sh = 1 in this process; ``rap_planes_sharded``
    on the 4-slab flagship; ``entry.dryrun_multichip(4)``."""
    import torch

    from algebraicmultigrid_tpu_torch import entry
    from algebraicmultigrid_tpu_torch.parallel import build_sharded_hierarchy, make_row_mesh, run_ranks, solve_sharded

    secs = {}
    t0 = time.perf_counter()
    res = run_ranks(sharded_rank, SHARD_RANKS, backend="gloo", device=device, timeout_s=SHARD_TIMEOUT_S)
    secs["ranks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mesh1 = make_row_mesh(device=device)
    A0 = ml.levels[0].A
    b = A0 @ np.ones(A0.shape[0])
    zero_counts()
    x1, it1, nr1 = solve_sharded(ml, b, mesh=mesh1, dtype="float32", reltol=SHARD_RELTOL)
    torch.cuda.synchronize()
    c1 = read_counts()
    h1 = build_sharded_hierarchy(ml, mesh1, dtype="float32")
    spmv1, vcycle1 = sharded_times(h1, device)
    del h1
    ml._device_cache.clear()
    torch.cuda.empty_cache()
    log(f"solve_sharded n_sh = 1: {it1} iterations ‖r‖ {nr1!r}, launches {c1}; L0 SpMV {spmv1!r} ms,"
        f" V-cycle {vcycle1!r} ms (the single card, CUDA events)")
    if any(c1[k] for k in SINGLE_CARD):
        raise AssertionError(f"solve_sharded at n_sh = 1 launched a single-card kernel: {c1}")
    Ap, mlu = unstructured_problem()
    hu1 = build_sharded_hierarchy(mlu, mesh1, dtype="float32")
    u_bsg = expected_vcycle_launches(hu1)[0]
    del hu1, Ap, mlu
    torch.cuda.empty_cache()
    secs["one_rank"] = time.perf_counter() - t0

    rap_err = check_sharded_ranks(res, "gloo", ml, it1, x1, u_bsg)
    row = dict(iterations=it1, spmv_ms=[r["spmv_ms"] for r in res], vcycle_ms=[r["vcycle_ms"] for r in res],
               one_card_spmv_ms=spmv1, one_card_vcycle_ms=vcycle1, k6_per_vcycle=u_bsg, rap_err=rap_err)

    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(SHARD_RANKS)
    secs["dryrun"] = time.perf_counter() - t0
    log(f"entry.dryrun_multichip({SHARD_RANKS}): {dry}")
    if [r["rank"] for r in dry] != list(range(SHARD_RANKS)) or len({r["normres"] for r in dry}) != 1:
        raise AssertionError(f"dryrun_multichip: {dry}")

    if torch.cuda.device_count() >= SHARD_RANKS:
        t0 = time.perf_counter()
        res_n = run_ranks(sharded_rank, SHARD_RANKS, backend="nccl", timeout_s=SHARD_TIMEOUT_S)
        check_sharded_ranks(res_n, "nccl", ml, it1, x1, u_bsg)
        secs["nccl"] = time.perf_counter() - t0
        row["nccl"] = True
    else:
        log(f"NCCL across cards was not run on this machine: it has {torch.cuda.device_count()} card(s),"
            f" the phase needs {SHARD_RANKS}")
        row["nccl"] = False
    log(f"phase 20 seconds: {secs}")
    row["seconds"] = secs
    return row


# --------------------------------------------------------------------------
# the flagship with bf16 coefficient planes (phases 14 and 15)
# --------------------------------------------------------------------------

# the C entries of K1–K4 with bf16 planes, by the vectors' dtype
BF16_SUFFIX = {"float32": "f32_bf16", "float64": "f64_bf16"}
# the f64 fixed cycles' plateau: the 5-point L0 stencil (4, −1) is exact in
# bf16, so 400 cycles go far below float32's (phase 5)
CYCLES_RELRES_F64 = 1e-10
# H100 SXM published peak, float64 outside the tensor cores (NVIDIA data
# sheet)
F64_FLOPS = 34e12


def bf16_path(device, ml, dtype, ref_counts=None, ref_levels=None):
    """Phases 14 (float32 vectors) and 15 (float64): the flagship lowered
    with bf16 planes under ``dtype`` vectors; K1–K4 against their plain
    versions and timed in turns with ``dtype``'s own planes, the refined
    solve and the fixed-cycle loop with the counters zeroed just before
    each, the loop's launches held against ``ref_counts``/``ref_levels``
    (phase 5's for float32; for float64 the same loop on float64 planes,
    run here).  The staged K3 (L0 under float32 vectors) is held bitwise
    against the tiled K3 and timed in turns with it, and the loop's K3
    launches by route are asserted: all staged under float32."""
    import dataclasses

    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, run_fixed_cycles
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    bf16 = torch.bfloat16
    key = str(dtype).removeprefix("torch.")
    tag = {"float32": "f32", "float64": "f64"}[key]
    rtol = FIXED_RTOL[key] if key == "float64" else KERNEL_RTOL
    cycles_relres = CYCLES_RELRES if key == "float32" else CYCLES_RELRES_F64
    t0 = time.perf_counter()
    h = amt.get_device_hierarchy(ml, device=device, dtype=dtype, coef_dtype=bf16)
    torch.cuda.synchronize()
    lowering_s = time.perf_counter() - t0
    href = amt.build_device_hierarchy(ml, device=device, dtype=dtype)

    def plans(hh, pipelined=True):
        return ([(L.fused.down_tile, L.fused.up_tile, L.fused.up_pipelined if pipelined else None,
                  L.fused.updown_tile) for L in hh.levels[: hh.tail_start]], hh.tail.tiles)

    legs = [L.fused for L in h.levels[: h.tail_start]]
    log(f"bf16 planes, {key} vectors, {N}x{N}: lowering_s {lowering_s!r} tail_start {h.tail_start};"
        f" plans (K1, K2, K2 pipelined, K3 tiles by leg level; K4 tiles) {plans(h)}; {key} planes' {plans(href)}")
    if len(ml.levels) + 1 != EXPECT_LEVELS or h.tail_start != EXPECT_TAIL_START:
        raise AssertionError(f"bf16 {key}: {len(ml.levels) + 1} levels, tail start {h.tail_start}")
    if not all(f is not None and (f.A.dtype, f.dinv.dtype, f.T.dtype, f.S.dtype) == (bf16,) * 4 and f.dtype == dtype
               for f in legs):
        raise AssertionError(f"bf16 {key}: a leg cache's A, D⁻¹, T, S are not all bf16 under {key} vectors")
    if not (all((L.A.dtype, L.T.dtype, L.S.dtype, L.dinv.dtype) == (bf16, bf16, bf16, dtype) for L in h.tail.levels)
            and h.tail.Mc.dtype == dtype):
        raise AssertionError(f"bf16 {key}: a tail level's A, T, S are not bf16 with D⁻¹ and Mc in {key}")
    if not all(L.A.data.dtype == dtype for L in h.levels):
        raise AssertionError(f"bf16 {key}: a level's own operator is not {key}")
    # the tiles are the vectors' plans; float64 K2 pipelines at L0 only with
    # 2-byte planes (its stage and tile buffers fit a block's shared memory)
    if plans(h, key == "float32") != plans(href, key == "float32") or (key == "float64" and not legs[0].up_pipelined):
        raise AssertionError(f"bf16 {key}: the plans differ from {key} planes' (K2 pipelined at L0 with bf16)")

    gen = torch.Generator(device="cpu").manual_seed(14)

    def vec(m, length):
        v = torch.zeros(length, dtype=dtype)
        v[:m] = torch.randn(m, generator=gen, dtype=dtype)
        return v.to(device)

    rows = {name: [] for name in ("fused_down", "fused_up", "fused_updown", "fused_tail")}

    def record(name, got, ref, fn, fn_ref, plain, work, **extra):
        """A row: errors against the plain version on the bf16 planes, the
        bf16 kernel timed in turns with the one on ``dtype``'s planes, the
        plain time and the bound with 2-byte planes."""
        errs = [errors(g, r) for g, r in zip(got, ref)]
        row = dict(extra, max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs))
        row[f"{tag}_ms"], row["ms"], row["turns_ms"] = in_turns(fn_ref, fn)
        row["plain_ms"] = time_ms(plain)
        row["bound_ms"], row["bound_by"] = bound(*work, dtype.itemsize, F32_FLOPS if tag == "f32" else F64_FLOPS)
        rows[name].append(row)

    for lvl in (0, 1):
        L, f, g = h.levels[lvl], h.levels[lvl].fused, href.levels[lvl].fused
        n, pad, nc = L.A.shape[0], L.A.rows_padded, L.R.shape[0]
        x, b, xc = vec(n, pad), vec(n, pad), vec(nc, nc)
        for x_zero in (False, True):
            record(
                "fused_down", vl.fused_down(f, x, b, x_zero=x_zero), vl.fused_down_reference(f, x, b, x_zero=x_zero),
                lambda: vl.fused_down(f, x, b, x_zero=x_zero), lambda: vl.fused_down(g, x, b, x_zero=x_zero),
                lambda: vl.fused_down_reference(f, x, b, x_zero=x_zero),
                leg_work(f, f.steps, False, True, x_zero=x_zero), level=lvl, dims=f.row_dims, x_zero=x_zero,
                leg_route="tiles", tile=f.down_tile,
            )
        record(
            "fused_up", [vl.fused_up(f, x, b, xc)], [vl.fused_up_reference(f, x, b, xc)],
            lambda: vl.fused_up(f, x, b, xc), lambda: vl.fused_up(g, x, b, xc),
            lambda: vl.fused_up_reference(f, x, b, xc), leg_work(f, f.steps, True, False), level=lvl,
            dims=f.row_dims, leg_route="pipelined" if f.up_pipelined else "tiles", tile=f.up_tile,
            ref_route="pipelined" if g.up_pipelined else "tiles",
        )
        record(
            "fused_updown", vl.fused_updown(f, x, b, xc), vl.fused_updown_reference(f, x, b, xc),
            lambda: vl.fused_updown(f, x, b, xc), lambda: vl.fused_updown(g, x, b, xc),
            lambda: vl.fused_updown_reference(f, x, b, xc), leg_work(f, f.steps2, True, True), level=lvl,
            dims=f.row_dims, tile=f.updown_tile, leg_route="staged" if f.updown_staged else "tiles",
        )
        if f.updown_staged:
            # the staged K3 in turns with the tiled K3 (one block a tile) on the same planes: bitwise equal
            tiles = dataclasses.replace(f, updown_staged=False)
            r = rows["fused_updown"][-1]
            r["route_equal"] = all(torch.equal(u, v) for u, v in zip(vl.fused_updown(f, x, b, xc),
                                                                     vl.fused_updown(tiles, x, b, xc)))
            r["ms"], r["route_ms"], r["route_turns_ms"] = in_turns(lambda: vl.fused_updown(f, x, b, xc),
                                                                   lambda: vl.fused_updown(tiles, x, b, xc))
    lvl = h.tail_start
    L = h.levels[lvl]
    x, b = vec(L.A.shape[0], L.A.rows_padded), vec(L.A.shape[0], L.A.rows_padded)
    for x_zero in (False, True):
        xin = torch.zeros_like(x) if x_zero else x
        record(
            "fused_tail", [tk.fused_tail(h.tail, xin, b, x_zero=x_zero)],
            [tk.fused_tail_reference(h.tail, xin, b, x_zero=x_zero)],
            lambda: tk.fused_tail(h.tail, xin, b, x_zero=x_zero),
            lambda: tk.fused_tail(href.tail, xin, b, x_zero=x_zero),
            lambda: tk.fused_tail_reference(h.tail, xin, b, x_zero=x_zero), tail_work(h.tail, x_zero), level=lvl,
            dims=h.tail.levels[0].row_dims, x_zero=x_zero,
        )
    for name, rs in rows.items():
        for r in rs:
            log(f"kernel {name}_{BF16_SUFFIX[key]} L{r['level']} {r['dims']}"
                + (f" x_zero={r['x_zero']}" if "x_zero" in r else "")
                + (f" {r['leg_route']}" if "leg_route" in r else "") + (f" tile {r['tile']}" if "tile" in r else "")
                + (f" ({tag} planes: {r['ref_route']})" if "ref_route" in r else "")
                + f": max_rel_err {r['max_rel_err']!r} max_abs_err {r['max_abs_err']!r} bf16 {r['ms']!r} ms"
                f" {tag} {r[f'{tag}_ms']!r} ms (in turns, {tag}/bf16/bf16/{tag}: {r['turns_ms']!r})"
                f" plain {r['plain_ms']!r} ms bound {r['bound_ms']!r} ms ({r['bound_by']}, 2-byte planes)"
                + (f"; tiles route {r['route_ms']!r} ms (in turns, staged/tiles/tiles/staged:"
                   f" {r['route_turns_ms']!r}), bitwise equal {r['route_equal']}" if "route_ms" in r else ""))
            if not r["max_rel_err"] <= rtol:
                raise AssertionError(f"{name} with bf16 planes under {key} disagrees with its plain version: {r}")
            if not r.get("route_equal", True):
                raise AssertionError(f"the staged {name} differs from its tiles under {key}: {r}")

    # the refined solve on b = A·1, then the fixed-cycle loop, counters zeroed before each
    b1 = ml.levels[0].A @ np.ones(N * N)
    torch.cuda.synchronize()
    zero_counts()
    t1 = time.perf_counter()
    stats = {}
    x, hist = amt.solve_refined(ml, b1, tol=TOL, max_rounds=MAX_ROUNDS, device=device, dtype=dtype, log=True,
                                stats=stats, coef_dtype=bf16)
    t2 = time.perf_counter()
    solve_counts = read_counts()
    relres = float(np.linalg.norm(b1 - ml.levels[0].A @ x) / np.linalg.norm(b1))
    log(f"bf16 {key} solve_refined (b = A·1): rounds {len(hist) - 1} pcg_iters_per_round {stats['inner_iters']}"
        f" relres {relres!r} history {hist} {t2 - t1!r} s; launches {solve_counts}")

    bv = torch.zeros(h.fine_padded, dtype=dtype, device=device)
    bv[: N * N] = torch.as_tensor(b1, dtype=dtype, device=device)
    xv = torch.zeros_like(bv)

    def fixed_400(hh):
        torch.cuda.synchronize()
        zero_counts()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        xf = run_fixed_cycles(hh, xv, bv, CYCLES)
        stop.record()
        torch.cuda.synchronize()
        xh = xf[: N * N].double().cpu().numpy()
        rel = float(np.linalg.norm(b1 - ml.levels[0].A @ xh) / np.linalg.norm(b1))
        return xh, rel, start.elapsed_time(stop) / CYCLES, read_counts(), read_level_counts(), read_route_counts()

    if ref_counts is None:
        _, rel_ref, ms_ref, ref_counts, ref_levels, _ = fixed_400(href)
        log(f"{key} planes fixed cycles {CYCLES}: ms_per_cycle {ms_ref!r} relres_after_cycles {rel_ref!r};"
            f" launches {ref_counts}; by level {ref_levels}")
    xh, relres_fixed, fixed_ms, cycle_counts, cycle_levels, cycle_routes = fixed_400(h)
    log(f"bf16 {key} fixed cycles {CYCLES}: ms_per_cycle {fixed_ms!r} relres_after_cycles {relres_fixed!r};"
        f" launches {cycle_counts}; by level {cycle_levels}; by route {cycle_routes}")

    # a V-cycle and a fixed cycle, dtype's planes and bf16 planes in turns
    times = {f"vcycle_{tag}": [], "vcycle_bf16": [], f"fixed_{tag}": [], "fixed_bf16": []}
    for hh, t in ((href, tag), (h, "bf16"), (h, "bf16"), (href, tag)):
        times[f"vcycle_{t}"].append(time_ms(lambda: _one_iteration(hh, amt.V(), xv, bv), reps=10))
        times[f"fixed_{t}"].append(time_ms(lambda: run_fixed_cycles(hh, xv, bv, 50), reps=2) / 50)
    del href
    log(f"bf16 {key} timings in turns ({tag}, bf16, bf16, {tag}), ms: {times}; card {card_line()}")

    if not (x.shape == (N * N,) and np.isfinite(x).all()):
        raise AssertionError(f"bf16 {key}: the solution is not a finite vector of the problem's size")
    if not (relres < TOL and len(hist) - 1 <= MAX_ROUNDS):
        raise AssertionError(f"bf16 {key} solve_refined relres {relres} after {len(hist) - 1} rounds")
    if not (all(solve_counts[k] > 0 for k in ("down", "up", "tail")) and solve_counts["updown"] == 0):
        raise AssertionError(f"the bf16 {key} solve did not launch K1, K2 and K4: {solve_counts}")
    if not (np.isfinite(xh).all() and relres_fixed < cycles_relres):
        raise AssertionError(f"bf16 {key} relres_after_cycles {relres_fixed} >= {cycles_relres}")
    if cycle_counts != ref_counts or cycle_levels != ref_levels:
        raise AssertionError(f"bf16 {key} fixed-cycle launches {cycle_counts} {cycle_levels} != {key} planes'"
                             f" {ref_counts} {ref_levels}")
    # every K3 launch staged under float32 vectors (the flagship's L0), in tiles under float64
    want_k3 = {f"updown/{'staged' if key == 'float32' else 'tiles'}": CYCLES - 1}
    if {k: v for k, v in cycle_routes.items() if k.startswith("updown/")} != want_k3:
        raise AssertionError(f"bf16 {key} fixed-cycle K3 launches by route {cycle_routes} != {want_k3}")
    summary = dict(vcycle_ms=times["vcycle_bf16"][0], fixed_ms=times["fixed_bf16"][0], fixed_400_ms=fixed_ms,
                   k3_routes={k: v for k, v in cycle_routes.items() if k.startswith("updown/")},
                   rounds=len(hist) - 1, pcg_iters=stats["inner_iters"], relres=relres,
                   relres_after_cycles=relres_fixed)
    summary[f"vcycle_{tag}_ms"], summary[f"fixed_{tag}_ms"] = times[f"vcycle_{tag}"][0], times[f"fixed_{tag}"][0]
    return rows, solve_counts, cycle_counts, cycle_levels, summary


# --------------------------------------------------------------------------
# the 3-D problem with bf16 planes (phase 16) and the structured
# Ruge–Stüben flagship (phase 17)
# --------------------------------------------------------------------------

# phase 16's cg_device against the f64 LatND operator, and its iterations
# against phase 10's float32 planes
N3_BF16_CG_TRUE = 1e-5
N3_BF16_ITERS = 2
# bench.py's AMG_BENCH_METHOD=rs at 4096²: what the JAX package's setup
# gives (host run of the same numpy code)
RS_LEVELS = 10
RS_OC = 4.536
RS_COARSE = 6624
# the f32 fixed cycles' plateau on the rs hierarchy: printed, held only
# to this sanity bound
RS_CYCLES_RELRES = 1e-4


def lattice_3d_bf16(device, ml, f32_iters):
    """Phase 16: phase 10's 256³ hierarchy lowered with bf16 planes under
    float32 (``bench.py``'s opt-in 3-D cell under its default
    ``AMG_COEF_DTYPE=bfloat16``): the LatND operators' planes bf16, K7's
    bf16 entry against its plain version and in turns with phase 10's
    float32 K7, ``cg_device`` with the counters zeroed just before, and a
    V-cycle's launches."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _get_fine_f64, _one_iteration
    from algebraicmultigrid_tpu_torch.ops.banded import mat_vec
    from algebraicmultigrid_tpu_torch.ops.kernels.sweep3d import Sweep3DCache, smooth_sweep3d, smooth_sweep3d_reference
    from algebraicmultigrid_tpu_torch.ops.lattice_nd_op import LatND

    bf16, f32 = torch.bfloat16, torch.float32
    t0 = time.perf_counter()
    h = amt.get_device_hierarchy(ml, device=device, dtype=f32, coef_dtype=bf16)
    torch.cuda.synchronize()
    lowering_s = time.perf_counter() - t0
    h32 = amt.get_device_hierarchy(ml, device=device, dtype=f32)  # phase 10's, cached on ml
    rows = tuple(L.A.shape[0] for L in ml.levels)
    oc = ml.operator_complexity()
    # each operator's format and the dtype it stores its coefficients in
    fmt = [tuple((type(M).__name__, str(M.data.dtype if isinstance(M, LatND) else M.dtype).removeprefix("torch."))
                 for M in (L.A, L.P, L.R)) for L in h.levels]
    L0, R0 = h.levels[0], h32.levels[0]
    log(f"3-D {N3}^3 bf16 planes: lowering_s {lowering_s!r} rows {rows} coarse {ml.final_A.shape}"
        f" operator_complexity {oc!r}; formats (A, P, R) with plane dtypes {fmt}; L0 K7 march"
        f" {L0.pre.march.args() if isinstance(L0.pre, Sweep3DCache) and L0.pre.march else None}"
        f" (float32 planes: {R0.pre.march.args() if R0.pre.march else None})")
    if rows != N3_ROWS or ml.final_A.shape != (N3_COARSE, N3_COARSE) or h.coarse.kind != "qr":
        raise AssertionError(f"3-D bf16: levels {rows} + {ml.final_A.shape}, not {N3_ROWS} + an 8-row QR")
    if abs(oc - N3_OC) > 1e-4:
        raise AssertionError(f"3-D bf16: operator complexity {oc} != {N3_OC}")
    if fmt[0] != (("LatND", "bfloat16"),) * 3 or not all(M.dtype == f32 for M in (L0.A, L0.P, L0.R)):
        raise AssertionError(f"3-D bf16: L0 is {fmt[0]}, not LatND A, P, R with bf16 planes under float32")
    if [tuple(t for t, _ in f) for f in fmt[1:]] != N3_FORMATS or any(d != "float32" for f in fmt[1:] for _, d in f):
        raise AssertionError(f"3-D bf16: L1-L4 lowered to {fmt[1:]}, not {N3_FORMATS} in float32")
    for c in (L0.pre, L0.post):
        if not (isinstance(c, Sweep3DCache) and c.A is L0.A and c.march is not None and c.dinv.dtype == f32):
            raise AssertionError(f"3-D bf16: L0 smoother {c!r} is not K7's march on the level's bf16 planes")

    gen = torch.Generator(device="cpu").manual_seed(16)
    n0, pad0 = L0.A.shape[0], L0.A.rows_padded
    x, b = (torch.zeros(pad0) for _ in range(2))
    x[:n0], b[:n0] = torch.randn(n0, generator=gen), torch.randn(n0, generator=gen)
    x, b = x.to(device), b.to(device)
    rows_k7 = []
    for c, c32 in ((L0.pre, R0.pre), (L0.post, R0.post)):
        got, want = smooth_sweep3d(c, x, b), smooth_sweep3d_reference(c, x, b)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(got, want)
        r = dict(level="L0", dims=c.dims, steps=c.steps, march=c.march.args(), max_abs_err=abs_err,
                 max_rel_err=rel_err)
        if c is L0.pre:
            r["f32_ms"], r["ms"], r["turns_ms"] = in_turns(lambda: smooth_sweep3d(c32, x, b),
                                                           lambda: smooth_sweep3d(c, x, b))
            r["plain_ms"] = time_ms(lambda: smooth_sweep3d_reference(c, x, b))
            r["bound_ms"], r["bound_by"] = bound(*sweep_work(c), 4)
        rows_k7.append(r)
        log(f"kernel sweep3d_bf16 L0 dims {c.dims} steps {c.steps} march {r['march']}: max_rel_err {rel_err!r}"
            f" max_abs_err {abs_err!r}"
            + (f" bf16 {r['ms']!r} ms f32 {r['f32_ms']!r} ms (in turns, f32/bf16/bf16/f32: {r['turns_ms']!r})"
               f" plain {r['plain_ms']!r} ms bound {r['bound_ms']!r} ms ({r['bound_by']}, 2-byte planes)"
               if "ms" in r else ""))
        if not rel_err <= KERNEL_RTOL:
            raise AssertionError(f"K7 with bf16 planes disagrees with its plain version: {r}")
    del x, b

    bh = np.random.default_rng(4).standard_normal(n0)  # phase 10's right-hand side
    A64 = _get_fine_f64(ml, device)
    b64 = torch.as_tensor(np.pad(bh, (0, A64.rows_padded - n0)), device=device)
    normb = float(torch.linalg.norm(b64))
    torch.cuda.synchronize()
    zero_counts()
    t1 = time.perf_counter()
    x_cg, iters, normr = amt.cg_device(ml, bh, tol=U_CG_TOL, device=device, dtype=f32, log=True, coef_dtype=bf16)
    t2 = time.perf_counter()
    counts = read_counts()
    xp = torch.zeros_like(b64)
    xp[:n0] = torch.as_tensor(x_cg, dtype=torch.float64, device=device)
    rr = float(torch.linalg.norm(b64 - mat_vec(A64, xp)) / normb)
    log(f"3-D bf16 cg_device: {iters} iterations (float32 planes, phase 10: {f32_iters}), its own relres"
        f" {normr / normb!r}, f64 LatND relres {rr!r}, {t2 - t1!r} s; launches {counts}")

    want_bsg, _ = expected_vcycle_launches(h)
    bv = torch.zeros(pad0, device=device)
    bv[:n0] = torch.as_tensor(bh, dtype=f32, device=device)
    xv = torch.zeros_like(bv)
    torch.cuda.synchronize()
    zero_counts()
    _one_iteration(h, amt.V(), xv, bv)
    torch.cuda.synchronize()
    per_cycle = read_counts()
    vc = [time_ms(lambda: _one_iteration(hh, amt.V(), xv, bv), reps=10) for hh in (h32, h, h, h32)]
    log(f"3-D bf16 vcycle_ms in turns (f32, bf16, bf16, f32) {vc}; launches per V-cycle {per_cycle};"
        f" expected sweep3d 2 bsg {want_bsg}")

    if not (x_cg.shape == (n0,) and np.isfinite(x_cg).all()):
        raise AssertionError("3-D bf16 cg_device: the solution is not a finite vector of the problem's size")
    if not (normr / normb < U_CG_TOL and rr < N3_BF16_CG_TRUE):
        raise AssertionError(f"3-D bf16 cg_device relres {normr / normb} (f64 LatND: {rr})")
    if abs(iters - f32_iters) > N3_BF16_ITERS:
        raise AssertionError(f"3-D bf16 cg_device took {iters} iterations, float32 planes {f32_iters}")
    if not (counts["sweep3d"] > 0 and counts["bsg"] > 0):
        raise AssertionError(f"the 3-D bf16 solve did not launch K7 and K6: {counts}")
    want = dict.fromkeys(per_cycle, 0)
    want.update(sweep3d=2, bsg=want_bsg)
    if per_cycle != want:
        raise AssertionError(f"3-D bf16 V-cycle launches {per_cycle} != {want}")
    summary = dict(vcycle_ms=(vc[1] + vc[2]) / 2, vcycle_f32_ms=(vc[0] + vc[3]) / 2, cg_iters=iters,
                   cg_f32_iters=f32_iters, cg_relres_f64=rr)
    return rows_k7, counts, per_cycle, summary


def rs_path(device):
    """Phase 17: ``bench.py``'s ``AMG_BENCH_METHOD=rs`` at 4096² —
    ``ruge_stuben`` with ``StructuredRS`` and multicolor GS (the structured
    fast path), lowered in float32: no legs, no tail, K5 on every Lat2D
    level (the semi-coarsened levels' wider stencils through its generic
    and wide instances), each held against its plain version and timed;
    ``solve_refined`` and 400 ``run_fixed_cycles`` on b = A·1 with the
    counters zeroed just before each; one V-cycle's launches (K5, and K6 on
    the BSG levels) and time."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, run_fixed_cycles
    from algebraicmultigrid_tpu_torch.ops.kernels.gs_sweep import GSSweepCache, smooth_gs, smooth_gs_reference
    from algebraicmultigrid_tpu_torch.ops.lattice_op import Lat2D

    gs = amt.GaussSeidel(ordering="multicolor")
    t0 = time.perf_counter()
    ml = amt.ruge_stuben(amt.poisson((N, N), lattice=True), CF=amt.StructuredRS(), presmoother=gs, postsmoother=gs)
    t1 = time.perf_counter()
    h = amt.get_device_hierarchy(ml, device=device, dtype=torch.float32)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    levels = len(ml.levels) + 1
    oc = ml.operator_complexity()
    coarse = ml.final_A.shape[0]
    lat = [i for i, L in enumerate(h.levels) if isinstance(L.A, Lat2D)]
    k5 = [i for i, L in enumerate(h.levels)
          if isinstance(L.pre, GSSweepCache) and isinstance(L.post, GSSweepCache) and L.pre.march is not None]
    log(f"rs {N}x{N}: setup_s {t1 - t0!r} lowering_s {t2 - t1!r} levels {levels} operator_complexity {oc!r}"
        f" coarse {coarse} rows ({h.coarse.kind}); level rows {[L.A.shape[0] for L in ml.levels]}")
    log(f"rs formats {[type(L.A).__name__ for L in h.levels]} Lat2D offsets"
        f" {[len(h.levels[i].A.offsets) for i in lat]} P bases"
        f" {[(h.levels[i].P.base_x, h.levels[i].P.base_y) for i in lat]} K5 levels {k5}"
        f" marches {[h.levels[i].pre.march.args() for i in k5]}; tail {h.tail_start}")
    if levels != RS_LEVELS or round(oc, 3) != RS_OC or coarse != RS_COARSE:
        raise AssertionError(f"rs: {levels} levels, operator complexity {oc}, coarse {coarse} rows")
    if h.tail is not None or any(L.fused is not None for L in h.levels) or not lat or k5 != lat:
        raise AssertionError(f"rs: legs or a tail, or K5 on levels {k5} where the Lat2D levels are {lat}")

    gen = torch.Generator(device="cpu").manual_seed(17)
    rows_k5 = []
    for lvl in lat:
        L = h.levels[lvl]
        n, pad = L.A.shape[0], L.A.rows_padded
        x, b = torch.zeros(pad), torch.zeros(pad)
        x[:n], b[:n] = torch.randn(n, generator=gen), torch.randn(n, generator=gen)
        x, b = x.to(device), b.to(device)
        for c in (L.pre, L.post):
            r = compare_sweep("gs_sweep", smooth_gs, smooth_gs_reference, c, x, b, f"L{lvl}", timed=c is L.pre)
            rows_k5.append(dict(r, offsets=len(c.offsets)))

    b1 = ml.levels[0].A @ np.ones(N * N)
    torch.cuda.synchronize()
    zero_counts()
    t3 = time.perf_counter()
    stats = {}
    x, hist = amt.solve_refined(ml, b1, tol=TOL, max_rounds=MAX_ROUNDS, device=device, log=True, stats=stats)
    t4 = time.perf_counter()
    solve_counts = read_counts()
    relres = float(np.linalg.norm(b1 - ml.levels[0].A @ x) / np.linalg.norm(b1))
    log(f"rs solve_refined (b = A·1): rounds {len(hist) - 1} pcg_iters_per_round {stats['inner_iters']}"
        f" relres {relres!r} history {hist} {t4 - t3!r} s; launches {solve_counts}")

    bv = torch.zeros(h.fine_padded, device=device)
    bv[: N * N] = torch.as_tensor(b1, dtype=torch.float32, device=device)
    xv = torch.zeros_like(bv)
    torch.cuda.synchronize()
    zero_counts()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    xf = run_fixed_cycles(h, xv, bv, CYCLES)
    stop.record()
    torch.cuda.synchronize()
    cycle_counts = read_counts()
    fixed_ms = start.elapsed_time(stop) / CYCLES
    xh = xf[: N * N].double().cpu().numpy()
    relres_fixed = float(np.linalg.norm(b1 - ml.levels[0].A @ xh) / np.linalg.norm(b1))
    log(f"rs fixed cycles {CYCLES}: ms_per_cycle (CUDA events) {fixed_ms!r} relres_after_cycles {relres_fixed!r};"
        f" launches {cycle_counts}")

    torch.cuda.synchronize()
    zero_counts()
    _one_iteration(h, amt.V(), xv, bv)
    torch.cuda.synchronize()
    per_cycle = read_counts()
    per_level = read_level_counts().get("gs", {})
    want_bsg, _ = expected_vcycle_launches(h)
    vcycle_ms = time_ms(lambda: _one_iteration(h, amt.V(), xv, bv), reps=10)
    log(f"rs vcycle_ms (CUDA events) {vcycle_ms!r}; launches per V-cycle {per_cycle} (expected gs {2 * len(lat)}"
        f" bsg {want_bsg}); K5 by level {per_level}; card {card_line()}")
    for r in rows_k5:
        r["launches_per_vcycle"] = per_level.get("x".join(str(d) for d in r["dims"]), 0)

    if not (x.shape == (N * N,) and np.isfinite(x).all()):
        raise AssertionError("rs: the solution is not a finite vector of the problem's size")
    if not (relres < TOL and len(hist) - 1 <= MAX_ROUNDS):
        raise AssertionError(f"rs solve_refined relres {relres} after {len(hist) - 1} rounds")
    if not (np.isfinite(xh).all() and relres_fixed < RS_CYCLES_RELRES):
        raise AssertionError(f"rs relres_after_cycles {relres_fixed} >= {RS_CYCLES_RELRES}")
    want = dict.fromkeys(per_cycle, 0)
    want.update(gs=2 * len(lat), bsg=want_bsg)
    if per_cycle != want or cycle_counts != {k: v * CYCLES for k, v in want.items()}:
        raise AssertionError(f"rs launches per V-cycle {per_cycle} (400 cycles {cycle_counts}), not {want}: 2 K5"
                             " a Lat2D level and the hierarchy's K6")
    if any(r["launches_per_vcycle"] != 2 for r in rows_k5):
        raise AssertionError(f"rs K5 launches by level {per_level}: not 2 (pre, post) on every Lat2D level")
    summary = dict(setup_s=t1 - t0, lowering_s=t2 - t1, levels=levels, operator_complexity=oc, coarse_rows=coarse,
                   rounds=len(hist) - 1, pcg_iters=stats["inner_iters"], relres=relres, fixed_400_ms=fixed_ms,
                   relres_after_cycles=relres_fixed, vcycle_ms=vcycle_ms)
    return rows_k5, solve_counts, per_cycle, summary


# --------------------------------------------------------------------------
# the public API tier and the non-factored R/P-plane legs and tail (phase 18)
# --------------------------------------------------------------------------

# phase 18's api.solve: float32 cycles on b = A·1 (bench.py's right-hand
# side), whose plateau (phase 5: 3.8e-6 after 400 cycles) sits under this
# tolerance
API_RELTOL = 1e-5
API_MAXITER = 50
# one non-factored against one factored V-cycle with float32 planes: the
# same P = (I − diag(s)A)T two ways, so float32 rounding apart (2-norm)
NF_VCYCLE_RTOL = 1e-5


def nonfactored_path(device, ml):
    """Phase 18: the flagship through the public API with
    ``symmetry=NoSymmetry()`` (no factored stash: the R/P-plane legs at L0,
    L1 and a non-factored tail), with bf16 planes under float32 cycles; the
    save/load round trip of phase 4's hierarchy and its refined solve; the
    new K1/K2/K4 entries against their plain versions and timed in turns
    with the factored entries on phase 4's hierarchy; K1/K2's non-factored
    tiles (asserted planned at L0 and L1, and the only route the solves
    launch there) and K4's (asserted planned at its grid levels L2 and L3)
    against and in turns with their pass route; the cycles, factored and
    not, timed in turns and compared."""
    import dataclasses
    import os
    import tempfile

    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, run_fixed_cycles
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    f32, bf16 = torch.float32, torch.bfloat16
    LP = ml.levels[0].A
    b1 = LP @ np.ones(N * N)
    gs = amt.GaussSeidel(ordering="multicolor")  # the flagship's smoother (the API's default is natural order)
    api_kw = dict(aggregate=amt.StructuredAggregation(box=BOX), symmetry=amt.NoSymmetry(), presmoother=gs,
                  postsmoother=gs)

    # (a) api.solve on the card, the counters zeroed just before
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    x, res = amt.solve(LP, b1, amt.SmoothedAggregationAMG(), engine="torch", device=device, dtype=f32, coef_dtype=bf16,
                       reltol=API_RELTOL, maxiter=API_MAXITER, log=True, **api_kw)
    api_s = time.perf_counter() - t0
    api_counts, api_levels, api_routes = read_counts(), read_level_counts(), read_route_counts()
    api_iters = len(res) - 1
    api_relres = float(np.linalg.norm(b1 - LP @ x.astype(np.float64)) / np.linalg.norm(b1))

    # the same setup, kept: its hierarchy is what api.solve lowered
    ml_nf = amt.init(amt.SmoothedAggregationAMG(), LP, b1, **api_kw).ml
    h_nf = amt.get_device_hierarchy(ml_nf, device=device, dtype=f32, coef_dtype=bf16)
    n_legs = h_nf.tail_start
    legs = [L.fused for L in h_nf.levels[:n_legs]]
    dims = [f"{f.row_dims[0]}x{f.row_dims[1]}" for f in legs]
    log(f"api.solve {N}x{N} (SmoothedAggregationAMG, NoSymmetry, multicolor GS, engine torch, float32 cycles,"
        f" bf16 planes): levels {len(ml_nf.levels) + 1} OC {ml_nf.operator_complexity()!r} tail_start"
        f" {h_nf.tail_start}; legs factored {[f.factored for f in legs]} R/P offsets"
        f" {[(len(f.offsR), len(f.offsP)) for f in legs]}; tail factored {h_nf.tail.factored} tiles"
        f" {h_nf.tail.tiles} up tiles {h_nf.tail.up_tiles}; {api_iters} V-cycles to relres {api_relres!r}"
        f" (its own {res[-1] / res[0]!r}) in"
        f" {api_s!r} s (setup, lowering and solve); launches {api_counts}; by level {api_levels}; by route"
        f" {api_routes}; K1/K2 nf tiles {[(f.down_tile, f.up_tile) for f in legs]}")
    want = dict.fromkeys(api_counts, 0)
    want.update(down_nf=n_legs * api_iters, up_nf=n_legs * api_iters, tail_nf=api_iters)
    want_levels = {k: dict.fromkeys(dims, api_iters) for k in ("down_nf", "up_nf")}
    if len(ml_nf.levels) + 1 != EXPECT_LEVELS or round(ml_nf.operator_complexity(), 3) != EXPECT_OC:
        raise AssertionError(f"api.solve hierarchy: {len(ml_nf.levels) + 1} levels, OC {ml_nf.operator_complexity()}")
    if h_nf.tail_start != EXPECT_TAIL_START or any(f is None or f.factored for f in legs) or h_nf.tail.factored:
        raise AssertionError("api.solve: L0, L1 do not all run non-factored legs over a non-factored tail")
    if not all((f.A.dtype, f.dinv.dtype, f.R.dtype, f.P.dtype) == (bf16,) * 4 for f in legs):
        raise AssertionError("api.solve: the legs' A, D⁻¹, R, P planes are not bf16")
    if not all((L.A.dtype, L.P.dtype, L.R.dtype, L.dinv.dtype) == (bf16, bf16, f32, f32) for L in h_nf.tail.levels):
        raise AssertionError("api.solve: a tail level's A, P are not bf16 with R, D⁻¹ in float32")
    if not (np.isfinite(x).all() and api_relres < 2 * API_RELTOL and res[-1] <= API_RELTOL * res[0]):
        raise AssertionError(f"api.solve relres {api_relres} after {api_iters} V-cycles")
    if api_counts != want or api_levels != want_levels:
        raise AssertionError(f"api.solve launches {api_counts} {api_levels} != {want} {want_levels}: the"
                             " non-factored K1/K2 on L0, L1 and K4 once a V-cycle, no masked sweep")
    planned = [(vl.plan_down_nf(f.row_dims, f.k, f.offsA, f.offsR, len(f.steps)),
                vl.plan_up_nf(f.row_dims, f.k, f.offsA, len(f.steps))) for f in legs]
    if any(None in p or (f.down_tile, f.up_tile) != p for f, p in zip(legs, planned)):
        raise AssertionError(f"api.solve: the non-factored L0/L1 tiles {[(f.down_tile, f.up_tile) for f in legs]}"
                             f" are not the plan's {planned}")
    if api_routes != {"down_nf/tiles": n_legs * api_iters, "up_nf/tiles": n_legs * api_iters}:
        raise AssertionError(f"api.solve: K1/K2 nf launches by route {api_routes}: not all in tiles")
    tail_plan = tk.tail_tiles(h_nf.tail.levels)
    grid = [L.row_dims[0] * L.row_dims[1] > tk.BLOCK_CELLS for L in h_nf.tail.levels]
    tiled = [t[0] > 0 and u[0] > 0 for t, u in zip(h_nf.tail.tiles, h_nf.tail.up_tiles)]
    if h_nf.tail.tiles != tail_plan or tiled != grid or sum(grid) != 2:
        raise AssertionError(f"api.solve: K4 nf's grid levels are not all tiled as planned: tiles"
                             f" {h_nf.tail.tiles} up {h_nf.tail.up_tiles}, plan {tail_plan}")

    # (b) save/load of phase 4's hierarchy, then the refined solve with bf16 planes
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "flagship.npz")
        t0 = time.perf_counter()
        amt.save_hierarchy(ml, path)
        size = os.path.getsize(path)
        ml_l = amt.load_hierarchy(path)
        io_s = time.perf_counter() - t0
    b = np.random.default_rng(0).standard_normal(N * N)
    torch.cuda.synchronize()
    zero_counts()
    stats = {}
    t0 = time.perf_counter()
    xl, hist = amt.solve_refined(ml_l, b, tol=TOL, max_rounds=MAX_ROUNDS, device=device, log=True, stats=stats,
                                 coef_dtype=bf16)
    load_s = time.perf_counter() - t0
    load_counts, load_routes = read_counts(), read_route_counts()
    load_relres = float(np.linalg.norm(b - LP @ xl) / np.linalg.norm(b))
    h_l = amt.get_device_hierarchy(ml_l, device=device, dtype=f32, coef_dtype=bf16)
    log(f"save/load {N}x{N}: {size} bytes, save+load {io_s!r} s; solve_refined (bf16 planes): rounds {len(hist) - 1}"
        f" pcg_iters_per_round {stats['inner_iters']} relres {load_relres!r} history {hist} {load_s!r} s"
        f" (lowering included); legs factored {[L.fused.factored for L in h_l.levels[: h_l.tail_start]]}, tail"
        f" factored {h_l.tail.factored}; launches {load_counts}; by route {load_routes}")
    if not (np.isfinite(xl).all() and load_relres < TOL and len(hist) - 1 <= MAX_ROUNDS):
        raise AssertionError(f"loaded flagship: relres {load_relres} after {len(hist) - 1} rounds")
    if h_l.tail_start != EXPECT_TAIL_START or any(L.fused.factored for L in h_l.levels[:2]) or h_l.tail.factored:
        raise AssertionError("the loaded flagship does not lower to non-factored legs and tail")
    if not (all(load_counts[k] > 0 for k in ("down_nf", "up_nf", "tail_nf"))
            and not any(load_counts[k] for k in ("down", "up", "updown", "tail", "gs"))):
        raise AssertionError(f"the loaded flagship's solve launches {load_counts}")
    if set(load_routes) != {"down_nf/tiles", "up_nf/tiles"}:
        raise AssertionError(f"the loaded flagship's K1/K2 nf launches by route {load_routes}: not all in tiles")

    # (c) each new entry against its plain version, timed in turns with the
    # factored entry of phase 4's hierarchy on the same vectors, and K1/K2
    # nf's tiles against and in turns with their pass route (the first
    # design); with bf16 planes (the configuration) and float32 planes
    gen = torch.Generator(device="cpu").manual_seed(18)

    def vec(m, length):
        v = torch.zeros(length)
        v[:m] = torch.randn(m, generator=gen)
        return v.to(device)

    rows = {name: [] for name in ("fused_down_nf", "fused_up_nf", "fused_tail_nf")}
    hier = {}
    for planes in ("bf16", "f32"):
        coef = bf16 if planes == "bf16" else None
        hier[planes] = (h_nf if coef else amt.build_device_hierarchy(ml_nf, device=device, dtype=f32),
                        amt.build_device_hierarchy(ml, device=device, dtype=f32, coef_dtype=coef))
        hn, hf = hier[planes]

        def record(name, got, ref, fn, fn_fact, plain, work, fn_pass=None, by_pass=None, **extra):
            errs = [errors(g, r) for g, r in zip(got, ref)]
            row = dict(extra, planes=planes, max_abs_err=max(e[0] for e in errs),
                       max_rel_err=max(e[1] for e in errs))
            row["factored_ms"], row["ms"], row["turns_ms"] = in_turns(fn_fact, fn)
            if fn_pass is not None:
                row["pass_rel_err"] = max(errors(g, q)[1] for g, q in zip(got, by_pass))
                row["pass_ms"], row["ms_vs_pass"], row["pass_turns_ms"] = in_turns(fn_pass, fn)
            row["plain_ms"] = time_ms(plain, reps=5)
            row["bound_ms"], row["bound_by"] = bound(*work, 4)
            rows[name].append(row)

        for lvl in (0, 1):
            L, f, g = hn.levels[lvl], hn.levels[lvl].fused, hf.levels[lvl].fused
            if f.down_tile is None or f.up_tile is None:
                raise AssertionError(f"level {lvl}'s non-factored K1/K2 have no tile: {f.down_tile}, {f.up_tile}")
            passed = dataclasses.replace(f, down_tile=None, up_tile=None)
            n, pad, nc = L.A.shape[0], L.A.rows_padded, L.R.shape[0]
            x, b, xc = vec(n, pad), vec(n, pad), vec(nc, nc)
            for x_zero in (False, True):
                record(
                    "fused_down_nf", vl.fused_down(f, x, b, x_zero=x_zero),
                    vl.fused_down_reference(f, x, b, x_zero=x_zero),
                    lambda: vl.fused_down(f, x, b, x_zero=x_zero), lambda: vl.fused_down(g, x, b, x_zero=x_zero),
                    lambda: vl.fused_down_reference(f, x, b, x_zero=x_zero),
                    leg_work(f, f.steps, False, True, x_zero=x_zero),
                    fn_pass=lambda: vl.fused_down(passed, x, b, x_zero=x_zero),
                    by_pass=vl.fused_down(passed, x, b, x_zero=x_zero),
                    level=lvl, dims=f.row_dims, x_zero=x_zero, factored_route=("tiles", g.down_tile),
                    tile=f.down_tile,
                )
            record(
                "fused_up_nf", [vl.fused_up(f, x, b, xc)], [vl.fused_up_reference(f, x, b, xc)],
                lambda: vl.fused_up(f, x, b, xc), lambda: vl.fused_up(g, x, b, xc),
                lambda: vl.fused_up_reference(f, x, b, xc), leg_work(f, f.steps, True, False),
                fn_pass=lambda: vl.fused_up(passed, x, b, xc), by_pass=[vl.fused_up(passed, x, b, xc)], level=lvl,
                dims=f.row_dims,
                factored_route=("pipelined" if g.up_pipelined else "tiles", g.up_tile), tile=f.up_tile,
            )
        lvl = hn.tail_start
        L = hn.levels[lvl]
        x, b = vec(L.A.shape[0], L.A.rows_padded), vec(L.A.shape[0], L.A.rows_padded)
        # the pass route K4 nf's tiles replaced: the same levels, the grid
        # levels' tiles set to (0, 0)
        t_pass = tk.make_fused_tail_cache(hn.tail.levels, hn.tail.Mc, tiles=((0, 0),) * len(hn.tail.levels))
        for x_zero in (False, True):
            xin = torch.zeros_like(x) if x_zero else x
            record(
                "fused_tail_nf", [tk.fused_tail(hn.tail, xin, b, x_zero=x_zero)],
                [tk.fused_tail_reference(hn.tail, xin, b, x_zero=x_zero)],
                lambda: tk.fused_tail(hn.tail, xin, b, x_zero=x_zero),
                lambda: tk.fused_tail(hf.tail, xin, b, x_zero=x_zero),
                lambda: tk.fused_tail_reference(hn.tail, xin, b, x_zero=x_zero), tail_work(hn.tail, x_zero),
                fn_pass=lambda: tk.fused_tail(t_pass, xin, b, x_zero=x_zero),
                by_pass=[tk.fused_tail(t_pass, xin, b, x_zero=x_zero)], level=lvl,
                dims=hn.tail.levels[0].row_dims, x_zero=x_zero, factored_route=("tail", hf.tail.tiles),
                tile=(hn.tail.tiles[:2], hn.tail.up_tiles[:2]),
            )
    # each call's 4-byte bound: that of the same call on float32 planes
    for rs in rows.values():
        for r in rs:
            twin = next(t for t in rs if t["planes"] == "f32"
                        and (t["level"], t.get("x_zero")) == (r["level"], r.get("x_zero")))
            r["bound_4byte_ms"] = twin["bound_ms"]
    for name, rs in rows.items():
        for r in rs:
            log(f"kernel {name} ({r['planes']} planes) L{r['level']} {r['dims']}"
                + (f" x_zero={r['x_zero']}" if "x_zero" in r else "")
                + f": max_rel_err {r['max_rel_err']!r} max_abs_err {r['max_abs_err']!r} non-factored {r['ms']!r} ms"
                f" factored {r['factored_ms']!r} ms {r['factored_route']} (in turns, factored/nf/nf/factored:"
                f" {r['turns_ms']!r}) plain {r['plain_ms']!r} ms bound {r['bound_ms']!r} ms ({r['bound_by']};"
                f" 4-byte planes {r['bound_4byte_ms']!r} ms)"
                + (f"; nf tile {r['tile']} {r['ms_vs_pass']!r} ms, nf pass route {r['pass_ms']!r} ms (in turns,"
                   f" pass/tile/tile/pass: {r['pass_turns_ms']!r}), rel err vs the pass route {r['pass_rel_err']!r}"
                   if "pass_ms" in r else "")
                + f"; card {card_line()}")
            if not r["max_rel_err"] <= KERNEL_RTOL:
                raise AssertionError(f"{name} on {r['planes']} planes disagrees with its plain version: {r}")
            if not r.get("pass_rel_err", 0.0) <= KERNEL_RTOL:
                raise AssertionError(f"{name} on {r['planes']} planes disagrees with its pass route: {r}")

    # (d) cycles: a V-cycle and 50 fixed cycles, factored and not, in turns
    # (bf16 planes); one V-cycle of each on the same x, b (float32 planes)
    bv = torch.zeros(hier["bf16"][0].fine_padded, device=device)
    bv[: N * N] = torch.as_tensor(b1, dtype=f32, device=device)
    xv = torch.zeros_like(bv)
    times = {"vcycle_factored": [], "vcycle_nf": [], "fixed_factored": [], "fixed_nf": []}
    hn, hf = hier["bf16"]
    for hh, t in ((hf, "factored"), (hn, "nf"), (hn, "nf"), (hf, "factored")):
        times[f"vcycle_{t}"].append(time_ms(lambda: _one_iteration(hh, amt.V(), xv, bv), reps=10))
        times[f"fixed_{t}"].append(time_ms(lambda: run_fixed_cycles(hh, xv, bv, 50), reps=2) / 50)
    agree = {}
    xr = vec(N * N, bv.shape[0])
    for planes, (hn, hf) in hier.items():
        y_nf = _one_iteration(hn, amt.V(), xr, bv).double()
        y_f = _one_iteration(hf, amt.V(), xr, bv).double()
        agree[planes] = (float((y_nf - y_f).norm() / y_f.norm()), errors(y_nf, y_f)[1])
    del hier
    log(f"non-factored vs factored cycles {N}x{N}, bf16 planes, in turns (factored, nf, nf, factored), ms: {times};"
        f" one V-cycle nf vs factored on the same x, b (norm_rel, max_rel) by planes: {agree}; card {card_line()}")
    if not agree["f32"][0] <= NF_VCYCLE_RTOL:
        raise AssertionError(f"the non-factored V-cycle disagrees with the factored one: {agree}")

    summary = dict(api_iters=api_iters, api_relres=api_relres, api_s=api_s, load_rounds=len(hist) - 1,
                   load_relres=load_relres, vcycle_nf_ms=times["vcycle_nf"][0], vcycle_factored_ms=times[
                       "vcycle_factored"][0], fixed_nf_ms=times["fixed_nf"][0],
                   fixed_factored_ms=times["fixed_factored"][0], vcycle_agree=agree)
    return rows, api_counts, api_levels, load_counts, summary


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
    h, solve_counts, solve_levels, vcycle_ms = main_path(device, ml, setup_s)
    cycle_counts, cycle_levels, fixed_ms = fixed_cycles(device, ml, h)
    del h
    torch.cuda.empty_cache()
    small_reference(device)
    ml._device_cache.clear()  # phase 12 lowers the flagship again
    torch.cuda.empty_cache()

    Ap, ml_u, h_u = unstructured_setup(device)
    rows_u = compare_unstructured_kernels(device, ml_u, h_u)
    u_counts, u_cycle = unstructured_solve(device, Ap, ml_u, h_u)
    del Ap, ml_u, h_u
    torch.cuda.empty_cache()

    rows_k7, counts_3d, cycle_3d, _, ml_3d, iters_3d = lattice_3d(device)
    torch.cuda.empty_cache()
    rows_k5, counts_fb, cycle_fb, vcycle_fb = lattice_fwd_bwd(device)
    torch.cuda.empty_cache()
    row_sub, counts_sub, cycle_sub = subcycle_path(device, ml)
    ml._device_cache.clear()
    torch.cuda.empty_cache()
    row_halo = slab_path(device, ml)
    ml._device_cache.clear()
    torch.cuda.empty_cache()
    bf16 = {"float32": bf16_path(device, ml, torch.float32, cycle_counts, cycle_levels)}
    ml._device_cache.clear()
    torch.cuda.empty_cache()
    bf16["float64"] = bf16_path(device, ml, torch.float64)
    ml._device_cache.clear()
    torch.cuda.empty_cache()
    rows_k7b, counts_3db, cycle_3db, summary_3db = lattice_3d_bf16(device, ml_3d, iters_3d)
    del ml_3d
    torch.cuda.empty_cache()
    rows_rs, counts_rs, cycle_rs, summary_rs = rs_path(device)
    torch.cuda.empty_cache()
    rows_nf, counts_nf, levels_nf, load_counts_nf, summary_nf = nonfactored_path(device, ml)
    ml._device_cache.clear()
    torch.cuda.empty_cache()
    rows_sub_bf16 = subcycle_bf16_path(device, ml)
    torch.cuda.empty_cache()
    row_shard = sharded_path(device, ml)
    torch.cuda.empty_cache()

    kernels = []
    for name, rs in rows.items():
        first = rs[0]  # L0 (the tail's entry level for K4), x read from its input
        row = dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=cycle_counts[COUNTER[name]], launches_solve=solve_counts[COUNTER[name]],
            max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=None,
        )
        if name in ("fused_down", "fused_up", "fused_updown"):
            # per level: L1's time (x read from its input) and the launches
            l1 = next(r for r in rs if r["level"] == 1)
            row.update(l1_ms=l1["ms"], l1_plain_ms=l1["plain_ms"], l1_bound_ms=l1["bound_ms"],
                       launches_by_level=cycle_levels.get(COUNTER[name], {}),
                       launches_solve_by_level=solve_levels.get(COUNTER[name], {}))
        if name in ("fused_down", "fused_up"):
            # the tiled route at L0 and L1 and the pass-by-pass route it replaced, timed in turns
            row.update(route_ms=first["route_ms"], l1_route_ms=l1["route_ms"],
                       routes={f"L{r['level']}": r["leg_route"] for r in rs})
        if name == "fused_updown":
            row["routes"] = {f"L{r['level']}": r["leg_route"] for r in rs}
        kernels.append(row)
    for name, rs in rows_u.items():
        first = rs[0]  # K6 at L0, scan_gs at L3
        row = dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=u_counts[COUNTER[name]], launches_per_vcycle=u_cycle[COUNTER[name]],
            max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=first["library_ms"],
        )
        if name == "scan_gs":
            # each level's route and time beside the streamed route's, in turns
            row["by_level"] = [{k: r[k] for k in ("level", "rows", "route", "ms", "streamed_ms", "bound_ms")}
                               for r in rs]
        kernels.append(row)
    for name, rs, counts, cycle in (("gs_sweep", rows_k5, counts_fb, cycle_fb),
                                    ("sweep3d", rows_k7, counts_3d, cycle_3d)):
        first = rs[0]  # L0's presmoother, float32
        row = dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=counts[COUNTER[name]], launches_per_vcycle=cycle[COUNTER[name]],
            max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=None,
        )
        # the march at L0 and the halo-tile kernel (the first design), timed in turns
        row.update(kernel_route=first["route"], tile_route_ms=first["tile_ms"])
        if name == "gs_sweep":
            # every Lat2D level's pre and post smoother on both routes, with its launches a V-cycle
            row["fwd_bwd_vcycle_ms"] = vcycle_fb
            row["by_level"] = [dict({k: r[k] for k in ("level", "dims", "steps", "march", "ms", "plain_ms", "bound_ms",
                                                       "launches_per_vcycle")},
                                    kernel_route=r["route"], tile_route_ms=r["tile_ms"]) for r in rs]
        kernels.append(row)
    kernels.append(dict(
        name="fused_subcycle", route="cuda", source=SOURCES["fused_subcycle"], replaces=REPLACES["fused_subcycle"],
        launches=cycle_sub["sub"], launches_solve=counts_sub["sub"], max_abs_err=row_sub["max_abs_err"],
        ms=row_sub["ms"], plain_ms=row_sub["plain_ms"], bound_ms=row_sub["bound_ms"], bound_by=row_sub["bound_by"],
        library_ms=None, route_ms=row_sub["route_ms"], tail_at_l1_ms=row_sub["tail_at_l1_ms"],
    ))
    kernels.append(dict(
        name="halo_stencil", route="cuda", source=SOURCES["halo_stencil"], replaces=REPLACES["halo_stencil"],
        **row_halo,
    ))
    for key, (rows_b, counts_b, cycle_b, levels_b, _) in bf16.items():
        tag = {"float32": "f32", "float64": "f64"}[key]
        suffix = "bf16" if key == "float32" else "f64_bf16"
        for name, rs in rows_b.items():
            first = rs[0]  # L0 (the tail's entry level for K4), x read from its input
            row = dict(
                name=f"{name}_{suffix}", route="cuda", source=SOURCES[name], replaces=REPLACES[name],
                launches=cycle_b[COUNTER[name]], launches_solve=counts_b[COUNTER[name]],
                max_abs_err=max(r["max_abs_err"] for r in rs), ms=first["ms"], plain_ms=first["plain_ms"],
                bound_ms=first["bound_ms"], bound_by=first["bound_by"], library_ms=None, entry=BF16_SUFFIX[key],
            )
            row[f"{tag}_ms"] = first[f"{tag}_ms"]
            if name != "fused_tail":
                l1 = next(r for r in rs if r["level"] == 1)
                row.update(l1_ms=l1["ms"], l1_bound_ms=l1["bound_ms"], launches_by_level=levels_b.get(COUNTER[name], {}))
                row[f"l1_{tag}_ms"] = l1[f"{tag}_ms"]
            if name in ("fused_up", "fused_updown"):
                row["routes"] = {f"L{r['level']}": r["leg_route"] for r in rs}
            if "route_ms" in first:  # the staged K3 and the tiled K3, in turns
                row["route_ms"] = first["route_ms"]
            kernels.append(row)
    first = rows_k7b[0]  # L0's presmoother
    kernels.append(dict(
        name="sweep3d_bf16", route="cuda", source=SOURCES["sweep3d"], replaces=REPLACES["sweep3d"],
        launches=counts_3db["sweep3d"], launches_per_vcycle=cycle_3db["sweep3d"],
        max_abs_err=max(r["max_abs_err"] for r in rows_k7b), ms=first["ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"], library_ms=None, entry="f32_bf16",
        f32_ms=first["f32_ms"], kernel_route="march",
    ))
    # K5 on the rs hierarchy: its widest level (the wide instance) as the row, every Lat2D level by level
    timed = [r for r in rows_rs if "ms" in r]
    first = max(timed, key=lambda r: r["offsets"])
    kernels.append(dict(
        name="gs_sweep_rs", route="cuda", source=SOURCES["gs_sweep"], replaces=REPLACES["gs_sweep"],
        launches=counts_rs["gs"], launches_per_vcycle=cycle_rs["gs"],
        max_abs_err=max(r["max_abs_err"] for r in rows_rs), ms=first["ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"], library_ms=None, level=first["level"],
        offsets=first["offsets"], kernel_route="march",
        by_level=[{k: r[k] for k in ("level", "dims", "offsets", "steps", "march", "ms", "plain_ms", "bound_ms",
                                     "launches_per_vcycle")} for r in timed],
    ))
    for name, rs in rows_nf.items():
        first = rs[0]  # L0 (the tail's entry level for K4) on bf16 planes, x read from its input
        row = dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=counts_nf[COUNTER[name]], launches_solve=load_counts_nf[COUNTER[name]],
            max_abs_err=max(r["max_abs_err"] for r in rs), ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"], library_ms=None, entry="f32_bf16",
            factored_ms=first["factored_ms"], pass_ms=first["pass_ms"], bound_4byte_ms=first["bound_4byte_ms"],
            by_call=[{k: r[k] for k in ("planes", "level", "dims", "ms", "factored_ms", "pass_ms", "plain_ms",
                                        "bound_ms", "bound_4byte_ms") if k in r} | ({"x_zero": r["x_zero"]}
                                                                                    if "x_zero" in r else {})
                     for r in rs],
        )
        if name != "fused_tail_nf":
            row["launches_by_level"] = levels_nf.get(COUNTER[name], {})
        kernels.append(row)
    for entry, r in rows_sub_bf16.items():
        tag = entry.split("_")[0]
        kernels.append(dict(
            name="fused_subcycle_" + ("bf16" if tag == "f32" else entry), route="cuda",
            source=SOURCES["fused_subcycle"], replaces=REPLACES["fused_subcycle"], launches=r["launches"],
            launches_solve=r.get("launches_solve"), max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None, entry=entry,
            **{f"{tag}_ms": r[f"{tag}_ms"], f"{tag}_bound_ms": r[f"{tag}_bound_ms"]},
        ))
    for row in kernels:
        if row["name"] == "bsg_spmv":  # on the sharded tier's replicated BSG levels, every rank
            row["sharded_launches_per_vcycle"] = row_shard["k6_per_vcycle"]
    log(f"flagship {N}x{N} f32, CUDA events: fixed cycle {fixed_ms!r} ms (first design, recorded:"
        f" {FIRST_DESIGN_FIXED_CYCLE_MS} ms), V-cycle {vcycle_ms!r} ms; card {card}")
    for key, b in bf16.items():
        log(f"flagship {N}x{N} bf16 planes, {key} vectors, CUDA events: {b[-1]}; card {card}")
    log(f"3-D {N3}^3 bf16 planes, CUDA events: {summary_3db}; card {card}")
    log(f"rs {N}x{N}, CUDA events: {summary_rs}; card {card}")
    log(f"api.solve NoSymmetry / save-load {N}x{N}, non-factored legs and tail, CUDA events: {summary_nf};"
        f" card {card}")
    log(f"subcycle bf16 planes {N}x{N}: {rows_sub_bf16}; card {card}")
    log(f"sharded tier {SHARD_RANKS} gloo ranks on one card, {N}x{N} solve_sharded, CUDA events: {row_shard};"
        f" card {card}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
