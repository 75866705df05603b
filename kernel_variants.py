"""Time the tiled and cooperative kernels under alternative launch shapes,
tiles and barrier schemes, on one NVIDIA card: by default the updown leg
K3 (``fused_updown``) and the whole-tail kernel K4 (``fused_tail``); with
the argument ``sweeps``, the whole-sweep kernels K7 (``sweep3d``, at L0 of
256³, symmetric GS) and K5 (``gs_sweep``, at 4096², forward GS) under
alternative thread blocks and loaded boxes; with ``subcycle``, the
whole-subcycle kernel K9 (``fused_subcycle``, at L1 of 4096²) with its
levels tiled or pass by pass (``sub_grid_passes``) and under alternative
tile edges; with ``legs``, the down and up legs K1 (``fused_down``) and K2
(``fused_up``) at L0 and L1 of 4096² under alternative tiles, routes and
load phases.

Each variant is the tree's CUDA sources with a few lines edited, built into
its own library (all builds run in parallel) and swapped in under the same
wrappers; the tree's own build is the variant ``tree``.  By default, at
4096², in two rounds, it prints for each variant K3's time at L0 (4096²)
under each tile of ``UPDOWN_TILES_L0`` and at L1 (1366²) under each of
``UPDOWN_TILES_L1``, with its error against its plain version; K4's time
(x = 0) under each tail tile of ``TAIL_TILES`` (set as
``tail_kernel.TAIL_TILE`` before its cache is built); and one fixed cycle
(``run_fixed_cycles``) with the planned tiles; then the same work as K3
through K2 + K1.  The K4 variant runs every grid level pass by pass
(``k4_grid_passes``: one grid barrier a pass, the first design's 35); two
diagnostics split K4's time, dropping its block-0 levels and coarse solve
(``k4_diag_no_block0``) or its grid levels (``k4_diag_no_grid``).  Run from
the repository root:

    python3 kernel_variants.py [legs | sweeps | subcycle]

In ``sweeps`` mode each source variant runs with each box of ``BOXES_3D``
/ ``BOXES_2D`` (the tile plus halo that ``tiled_sweep.plan_box`` starts
from), with the error against the plain version.  In ``subcycle`` mode each
source variant runs K9 with each tile edge of ``SUB_TILES`` (set as
``tail_kernel.TAIL_TILE``, cut to the register box by the plan), with the
error against the plain version, and a fixed cycle (``run_fixed_cycles``)
at the planned tiles.  In ``legs`` mode each source variant (which legs
read everything in their first memory phase: ``LEG_VARIANTS``) runs K1
from x and from zero and K2 under each tile of ``LEG_TILES``, one tile a
block and, for K2 where its stage fits, pipelined; then the legs pass by
pass; then K3, K4, a V-cycle and a fixed cycle with the planned tiles.
"""

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

N = 4096
ROUNDS = 2

# name -> [(file, old text, new text)]
VARIANTS = {
    "tree": [],
    "k4_grid_passes": [("tail_levels.cuh", "if (L.tile_x > 0) {", "if (false) {")],
    # diagnostics, not designs (their results are wrong, their errors say
    # so): K4 without its block-0 levels and coarse solve, or without its
    # grid levels, to split its time
    "k4_diag_no_block0": [("tail_levels.cuh", "  if (blockIdx.x == 0) {", "  if (false) {")],
    "k4_diag_no_grid": [
        ("tail_levels.cuh", "for (int l = 0; l < n_grid; ++l) {", "for (int l = 0; l < 0; ++l) {"),
        ("tail_levels.cuh", "for (int l = n_grid - 1; l >= 0; --l) {", "for (int l = -1; l >= 0; --l) {"),
    ],
}
# K3 tiles, each box within the register map's 64 x 64 cells.  L0
# (5-point, halo 7): (48, 48) is the planned box (62 x 62).  L1 (9-point,
# halo 15): (33, 33) is the planned box (63 x 63).
UPDOWN_TILES_L0 = [(18, 48), (24, 48), (48, 48)]
UPDOWN_TILES_L1 = [(33, 33), (24, 30)]
# K4 tail tiles (cut to the register box by the plan)
TAIL_TILES = [(18, 18), (27, 27), (48, 48)]


SWEEP_VARIANTS = {
    "tree": [],
    "threads512": [
        ("sweep_tile.cuh", "kSweepThreads = 256;", "kSweepThreads = 512;"),
        ("sweep_tile.cuh", "y = ND == 3 ? 4 : 8;", "y = ND == 3 ? 4 : 16;"),
        ("sweep_tile.cuh", "z = ND == 3 ? 2 : 1;", "z = ND == 3 ? 4 : 1;"),
    ],
    "threads1024": [
        ("sweep_tile.cuh", "kSweepThreads = 256;", "kSweepThreads = 1024;"),
        ("sweep_tile.cuh", "y = ND == 3 ? 4 : 8;", "y = ND == 3 ? 8 : 32;"),
        ("sweep_tile.cuh", "z = ND == 3 ? 2 : 1;", "z = ND == 3 ? 4 : 1;"),
    ],
}
# K1/K2 (legs mode): in the tree K1's tiles read everything in their first
# memory phase (leg_tile.cuh EARLY) and K2's read x and S in their
# correction, as K3's do; down_plain gives K1 K3's phases, up_early gives
# K2 one memory phase.  K2's pipelined route is a plan flag, swept at run
# time on 5-point levels.
LEG_EARLY = "const bool early = down && !up;"
LEG_VARIANTS = {
    "tree": [],
    "down_plain": [("vcycle_legs.cu", LEG_EARLY, "const bool early = false;")],
    "up_early": [("vcycle_legs.cu", LEG_EARLY, "const bool early = down != up;")],
}
# K1/K2 tiles per level and leg (the first is the plan's at 4096²)
LEG_TILES = {
    0: {"down": [(54, 54), (48, 48), (36, 54)], "up": [(54, 54), (48, 48), (36, 54)]},
    1: {"down": [(45, 45), (36, 36), (24, 45)], "up": [(48, 48), (36, 36), (24, 48)]},
}
SUB_VARIANTS = {
    "tree": [],
    "sub_grid_passes": [("tail_levels.cuh", "if (L.tile_x > 0) {", "if (false) {")],
}
SUB_TILES = (18, 27, 36, 45)
# (12, 12, 64) is lifted to (14, 14, 64): a one-step-per-halo tile keeps 8 cells
BOXES_3D = [(14, 14, 64), (20, 20, 64), (16, 16, 64), (24, 24, 64), (14, 16, 128), (32, 32, 32)]
BOXES_2D = [(1, 32, 64), (1, 64, 128), (1, 32, 128), (1, 16, 128), (1, 64, 64), (1, 16, 256)]


def edit(text, old, new):
    if old not in text:
        raise SystemExit(f"variant edit no longer matches the source: {old!r}")
    return text.replace(old, new)


def build(root, variants):
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    for name, edits in variants.items():
        d = root / name
        d.mkdir()
        for f in vl.SOURCES + vl.HEADERS:
            text = f.read_text()
            for fname, old, new in edits:
                if fname == f.name:
                    text = edit(text, old, new)
            (d / f.name).write_text(text)
        try:
            vl.build_library(d / "lib.so", [d / f.name for f in vl.SOURCES])
        except (RuntimeError, subprocess.CalledProcessError) as e:
            raise SystemExit(f"variant {name} failed to build: {e}")


def sweeps(use):
    """K7 at 256³ and K5 at 4096², per source variant and box."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.lattice import lattice_coloring
    from algebraicmultigrid_tpu_torch.models.lattice_nd import lattice_coloring_nd
    from algebraicmultigrid_tpu_torch.ops.kernels import tiled_sweep as ts
    from algebraicmultigrid_tpu_torch.ops.kernels.gs_sweep import build_gs_sweep_cache, smooth_gs, smooth_gs_reference
    from algebraicmultigrid_tpu_torch.ops.kernels.sweep3d import (
        build_sweep3d_cache, smooth_sweep3d, smooth_sweep3d_reference,
    )
    from algebraicmultigrid_tpu_torch.ops.lattice_nd_op import latnd_from_spec
    from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec

    import chip_smoke as cs

    gen = torch.Generator().manual_seed(0)
    cases = []
    for dims, fwd_bwd, boxes in (((256,) * 3, (True, True), BOXES_3D), ((N, N), (True, False), BOXES_2D)):
        spec = amt.poisson(dims, lattice=True).spec
        if len(dims) == 3:
            A = latnd_from_spec(spec, torch.float32, "cuda")
            tab, nc = lattice_coloring_nd(spec)
            build_c, fn, ref = build_sweep3d_cache, smooth_sweep3d, smooth_sweep3d_reference
        else:
            A = lat2d_from_spec(spec, torch.float32, "cuda", row_pad=8)
            tab, nc = lattice_coloring(spec)
            build_c, fn, ref = build_gs_sweep_cache, smooth_gs, smooth_gs_reference
        n = A.shape[0]
        dinv = torch.as_tensor(np.pad(1.0 / spec.diagonal(), (0, A.rows_padded - n)), dtype=torch.float32).cuda()
        x = torch.randn(A.rows_padded, generator=gen).cuda()
        b = torch.randn(A.rows_padded, generator=gen).cuda()
        for box in boxes:
            ts.BOX[len(dims)] = box
            c = build_c(A, dinv, tab, nc, 1.0, 1, *fwd_bwd)
            cases.append((dims, box, c, fn, x, b, ref(c, x, b)))
    for rnd in range(ROUNDS):
        for name in SWEEP_VARIANTS:
            use(name)
            for dims, box, c, fn, x, b, want in cases:
                err = cs.errors(fn(c, x, b), want)[1]
                ms = cs.time_ms(lambda: fn(c, x, b))
                print(f"round {rnd} {name:12s} {dims} box {c.box}: {ms!r} ms  max_rel_err {err!r}", flush=True)


def subcycle(use):
    """K9 at L1 of 4096², per source variant and tile edge, and a fixed
    cycle per variant."""
    import dataclasses

    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import run_fixed_cycles
    from algebraicmultigrid_tpu_torch.ops.kernels import subcycle_kernel as sk
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk

    import chip_smoke as cs

    planned = tk.TAIL_TILE
    ml = cs.setup(N)
    h = amt.build_device_hierarchy(ml, device="cuda", dtype=torch.float32, subcycle=True)
    top, tail = h.sub.top, h.sub.tail
    L1 = h.levels[1]
    gen = torch.Generator().manual_seed(0)
    b = torch.zeros(L1.A.rows_padded)
    b[: L1.A.shape[0]] = torch.randn(L1.A.shape[0], generator=gen)
    b = b.cuda()
    want = sk.fused_subcycle_reference(h.sub, b)
    bf = torch.zeros(h.fine_padded, device="cuda")
    bf[: N * N] = torch.as_tensor(ml.levels[0].A @ np.ones(N * N), dtype=torch.float32, device="cuda")
    for rnd in range(ROUNDS):
        for name in SUB_VARIANTS:
            use(name)
            for edge in SUB_TILES:
                tk.TAIL_TILE = (edge, edge)
                c = sk.make_fused_subcycle_cache(top, tail)
                err = cs.errors(sk.fused_subcycle(c, b), want)[1]
                ms = cs.time_ms(lambda: sk.fused_subcycle(c, b))
                print(f"round {rnd} {name:15s} tiles {c.tiles[:3]}: K9 {ms!r} ms  max_rel_err {err!r}", flush=True)
            tk.TAIL_TILE = planned
            hh = dataclasses.replace(h, sub=sk.make_fused_subcycle_cache(top, tail))
            fc = cs.time_ms(lambda: run_fixed_cycles(hh, torch.zeros_like(bf), bf, 50), reps=2) / 50
            print(f"round {rnd} {name:15s} tiles {hh.sub.tiles[:3]}: fixed cycle {fc!r} ms", flush=True)


def legs(use):
    """K1 (from x and from zero) and K2 at L0/L1 of 4096² per source
    variant, tile and route (one tile a block; K2 also pipelined where its
    stage fits), and pass by pass; K3, K4 and a V-cycle and a fixed cycle
    with the planned tiles."""
    import dataclasses

    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, run_fixed_cycles
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    import chip_smoke as cs

    use("tree")
    ml = cs.setup(N)
    h = amt.build_device_hierarchy(ml, device="cuda", dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)

    def vec(m, length):
        v = torch.zeros(length)
        v[:m] = torch.randn(m, generator=gen)
        return v.cuda()

    cases, vecs = {}, {}
    for lvl in (0, 1):
        f, L = h.levels[lvl].fused, h.levels[lvl]
        n, nc = L.A.shape[0], L.R.shape[0]
        x, b, xc = vecs[lvl] = vec(n, L.A.rows_padded), vec(n, L.A.rows_padded), vec(nc, nc)
        calls = {
            "down": (vl.fused_down, lambda c, x=x, b=b: (c, x, b), vl.fused_down_reference(f, x, b)),
            "down0": (vl.fused_down, lambda c, x=x, b=b: (c, x, b, True),
                      vl.fused_down_reference(f, x, b, x_zero=True)),
            "up": (vl.fused_up, lambda c, x=x, b=b, xc=xc: (c, x, b, xc), (vl.fused_up_reference(f, x, b, xc),)),
        }
        cases[lvl] = (f, calls)
    bf = torch.zeros(h.fine_padded, device="cuda")
    bf[: N * N] = torch.as_tensor(ml.levels[0].A @ np.ones(N * N), dtype=torch.float32, device="cuda")
    xf = torch.zeros_like(bf)
    bt = vec(h.levels[2].A.shape[0], h.levels[2].A.rows_padded)
    f0 = h.levels[0].fused
    x0, b0, xc0 = vecs[0]

    def timed(fn, c, args, want):
        got = fn(*args(c))
        got = got if isinstance(got, tuple) else (got,)
        err = max(cs.errors(g, r)[1] for g, r in zip(got, want))
        return cs.time_ms(lambda: fn(*args(c))), err

    for rnd in range(ROUNDS):
        for name in LEG_VARIANTS:
            use(name)
            for lvl, (f, calls) in cases.items():
                for leg, (fn, args, want) in calls.items():
                    key = "up" if leg == "up" else "down"
                    for tile in LEG_TILES[lvl][key]:
                        base = dataclasses.replace(f, **{f"{key}_tile": tile}, up_pipelined=False)
                        routes = [("tiles", base)]
                        if key == "up" and vl.plan_up_pipelined(base, 4):
                            routes.append(("pipelined", dataclasses.replace(base, up_pipelined=True)))
                        for route, c in routes:
                            ms, err = timed(fn, c, args, want)
                            print(f"round {rnd} {name:10s} L{lvl} {leg:5s} {route:9s} tile {tile}: {ms!r} ms"
                                  f"  max_rel_err {err!r}", flush=True)
                c = dataclasses.replace(f, down_tile=None, up_tile=None, up_pipelined=False)
                for leg, (fn, args, want) in calls.items():
                    ms, err = timed(fn, c, args, want)
                    print(f"round {rnd} {name:10s} L{lvl} {leg:5s} pass: {ms!r} ms  max_rel_err {err!r}", flush=True)
            k3 = cs.time_ms(lambda: vl.fused_updown(f0, x0, b0, xc0))
            k4 = cs.time_ms(lambda: tk.fused_tail(h.tail, torch.zeros_like(bt), bt, x_zero=True), reps=50)
            vc = cs.time_ms(lambda: _one_iteration(h, amt.V(), xf, bf), reps=10)
            fc = cs.time_ms(lambda: run_fixed_cycles(h, xf, bf, 50), reps=2) / 50
            print(f"round {rnd} {name:10s} planned (L0 {f0.down_tile}/{f0.up_tile} up pipelined {f0.up_pipelined},"
                  f" L1 {h.levels[1].fused.down_tile}/{h.levels[1].fused.up_tile}): K3 L0 {k3!r} ms K4 {k4!r} ms"
                  f" V-cycle {vc!r} ms fixed cycle {fc!r} ms", flush=True)


def legs_and_tail(use):
    """K3 at L0/L1 of 4096² per tile, K4 per tail tile, a fixed cycle, per
    source variant; then K2 + K1 at L0/L1."""
    import dataclasses

    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import run_fixed_cycles
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    import chip_smoke as cs

    use("tree")
    ml = cs.setup(N)
    h = amt.build_device_hierarchy(ml, device="cuda", dtype=torch.float32)
    L0, L1 = h.levels[0].fused, h.levels[1].fused
    gen = torch.Generator().manual_seed(0)

    def vec(m, length):
        v = torch.zeros(length)
        v[:m] = torch.randn(m, generator=gen)
        return v.cuda()

    n0, n1 = N * N, L1.row_dims[0] * L1.row_dims[1]
    nc0, nc1 = L0.col_dims[0] * L0.col_dims[1], L1.col_dims[0] * L1.col_dims[1]
    legs = {0: (L0, vec(n0, h.fine_padded), vec(n0, h.fine_padded), vec(nc0, nc0)),
            1: (L1, vec(n1, n1), vec(n1, n1), vec(nc1, nc1))}
    refs = {lvl: vl.fused_updown_reference(*args) for lvl, args in legs.items()}
    bt = vec(h.levels[2].A.shape[0], h.levels[2].A.rows_padded)
    ref_t = tk.fused_tail_reference(h.tail, torch.zeros_like(bt), bt, x_zero=True)
    bf = torch.zeros(h.fine_padded, device="cuda")
    bf[: N * N] = torch.as_tensor(ml.levels[0].A @ np.ones(N * N), dtype=torch.float32, device="cuda")
    planned, tails = tk.TAIL_TILE, {}
    for t in TAIL_TILES:
        tk.TAIL_TILE = t
        tails[t] = tk.make_fused_tail_cache(h.tail.levels, h.tail.Mc)
    tk.TAIL_TILE = planned
    for rnd in range(ROUNDS):
        for name in VARIANTS:
            use(name)
            for lvl, tiles in ((0, UPDOWN_TILES_L0), (1, UPDOWN_TILES_L1)):
                f, x, b, xc = legs[lvl]
                for tile in tiles:
                    ft = dataclasses.replace(f, updown_tile=tile)
                    err = max(cs.errors(g, r)[1] for g, r in zip(vl.fused_updown(ft, x, b, xc), refs[lvl]))
                    ms = cs.time_ms(lambda: vl.fused_updown(ft, x, b, xc))
                    print(f"round {rnd} {name:15s} K3 L{lvl} tile {tile}: {ms!r} ms  max_rel_err {err!r}", flush=True)
            for tile, c in tails.items():
                err = cs.errors(tk.fused_tail(c, torch.zeros_like(bt), bt, x_zero=True), ref_t)[1]
                ms = cs.time_ms(lambda: tk.fused_tail(c, torch.zeros_like(bt), bt, x_zero=True), reps=50)
                print(f"round {rnd} {name:15s} K4 tail tile {tile} (planned {c.tiles[:2]}): {ms!r} ms"
                      f"  max_rel_err {err!r}", flush=True)
            fc = cs.time_ms(lambda: run_fixed_cycles(h, torch.zeros_like(bf), bf, 50), reps=2) / 50
            print(f"round {rnd} {name:15s} fixed cycle {fc!r} ms (K3 tile {L0.updown_tile},"
                  f" tail tiles {h.tail.tiles[:2]})", flush=True)
    use("tree")
    for lvl, (f, x, b, xc) in legs.items():
        ms = cs.time_ms(lambda: vl.fused_down(f, vl.fused_up(f, x, b, xc), b))
        print(f"K2 + K1 at L{lvl}: {ms!r} ms")


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: kernel_variants needs one")
        return 1
    mode = sys.argv[1] if sys.argv[1:] else ""
    variants = {"sweeps": SWEEP_VARIANTS, "subcycle": SUB_VARIANTS, "legs": LEG_VARIANTS}.get(mode, VARIANTS)
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import run_fixed_cycles
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    import chip_smoke as cs

    card = cs.card_line()
    print(f"card: {card}")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        build(root, variants)
        print(f"{len(variants)} variants built in {time.perf_counter() - t!r} s", flush=True)

        def use(name):
            vl._lib = None
            vl.library_path = lambda: root / name / "lib.so"
            vl.load_library()

        if variants is SWEEP_VARIANTS:
            sweeps(use)
            print(card)
            return 0
        if variants is SUB_VARIANTS:
            subcycle(use)
            print(card)
            return 0
        if variants is LEG_VARIANTS:
            legs(use)
            print(card)
            return 0
        legs_and_tail(use)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
