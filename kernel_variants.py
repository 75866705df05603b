"""Time the cooperative kernels (K3 ``fused_updown``, K4 ``fused_tail``)
under alternative launch shapes and cell loops, on one NVIDIA card; with
the argument ``sweeps``, the whole-sweep kernels K7 (``sweep3d``, at L0 of
256³, symmetric GS) and K5 (``gs_sweep``, at 4096², forward GS) under
alternative thread blocks and loaded boxes; with ``subcycle``, the
whole-subcycle kernel K9 (``fused_subcycle``, at L1 of 4096²) under
alternative thread blocks (1024 threads, one block an SM, as K4; smaller
blocks, several an SM, as K5) and tile edges.

Each variant is the tree's CUDA sources with a few lines edited, built into
its own library (all builds run in parallel) and swapped in under the same
wrappers; the tree's own build is the variant ``tree``.  At 4096², in two
rounds, it prints each variant's K3 time at L0 (4096²) and L1 (1366²), its
K4 time (x = 0), one fixed cycle (``run_fixed_cycles``) and K3's error
against its plain version, then the same work through K2 + K1.  Run from the
repository root:

    python3 kernel_variants.py [sweeps | subcycle]

In ``sweeps`` mode each source variant runs with each box of ``BOXES_3D``
/ ``BOXES_2D`` (the tile plus halo that ``tiled_sweep.plan_box`` starts
from), with the error against the plain version.  In ``subcycle`` mode each
source variant runs K9 with each tile edge of ``SUB_TILES`` (the cache
shrinks a tile whose shared memory does not fit), with the error against
the plain version, and a fixed cycle (``run_fixed_cycles``) at each
variant's default tile.
"""

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

N = 4096
ROUNDS = 2

CHUNK_LOOP = '''template <typename F>
__device__ __forceinline__ void for_cells(int Wx, int Wy, int first,
                                          int stride, F&& f) {
  const int chunks = (Wy + blockDim.x - 1) / blockDim.x;
  for (int v = first; v < Wx * chunks; v += stride) {
    const int i = v / chunks;
    const int j = (v - i * chunks) * blockDim.x + threadIdx.x;
    if (j < Wy) f(i, j);
  }
}

'''

# name -> [(file, old text, new text)]
VARIANTS = {
    "tree": [],
    "k3_256x8": [
        ("vcycle_legs.cu", "kCoopThreads = 1024;", "kCoopThreads = 256;"),
        ("vcycle_legs.cu", "kCoopMinBlocks = 2;", "kCoopMinBlocks = 8;"),
    ],
    "k3_256x1": [
        ("vcycle_legs.cu", "kCoopThreads = 1024;", "kCoopThreads = 256;"),
        ("vcycle_legs.cu", "kCoopMinBlocks = 2;", "kCoopMinBlocks = 1;"),
    ],
    "row_chunk_loop": [("stencil.cuh", "for_cells", None)],
    "k4_all_grid": [("tail_kernel.cu", "kBlockCells = 4096;", "kBlockCells = 0;")],
    "k4_512": [("tail_kernel.cu", "kTailThreads = 1024;", "kTailThreads = 512;")],
}


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
SUB_VARIANTS = {
    "tree": [],
    "sub512x2": [
        ("subcycle_kernel.cu", "kSubThreads = 1024;", "kSubThreads = 512;"),
        ("subcycle_kernel.cu", "kSubMinBlocks = 1;", "kSubMinBlocks = 2;"),
    ],
    "sub256x4": [
        ("subcycle_kernel.cu", "kSubThreads = 1024;", "kSubThreads = 256;"),
        ("subcycle_kernel.cu", "kSubMinBlocks = 1;", "kSubMinBlocks = 4;"),
    ],
    "sub256x2": [
        ("subcycle_kernel.cu", "kSubThreads = 1024;", "kSubThreads = 256;"),
        ("subcycle_kernel.cu", "kSubMinBlocks = 1;", "kSubMinBlocks = 2;"),
    ],
}
SUB_TILES = (24, 36, 48, 72, 96)
# (12, 12, 64) is lifted to (14, 14, 64): a one-step-per-halo tile keeps 8 cells
BOXES_3D = [(14, 14, 64), (20, 20, 64), (16, 16, 64), (24, 24, 64), (14, 16, 128), (32, 32, 32)]
BOXES_2D = [(1, 32, 64), (1, 64, 128), (1, 32, 128), (1, 16, 128), (1, 64, 64), (1, 16, 256)]


def edit(text, old, new):
    if new is None:  # swap the for_cells loop for the row-chunk loop
        a = text.index("template <typename F>")
        b = text.index("// ---- host-side helpers")
        return text[:a] + CHUNK_LOOP + text[b:]
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

    import chip_smoke as cs

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
            for tile in SUB_TILES:
                c = sk.make_fused_subcycle_cache(top, tail, tile=tile)
                err = cs.errors(sk.fused_subcycle(c, b), want)[1]
                ms = cs.time_ms(lambda: sk.fused_subcycle(c, b))
                print(f"round {rnd} {name:10s} tile {c.tile:3d}: K9 {ms!r} ms  max_rel_err {err!r}", flush=True)
            hh = dataclasses.replace(h, sub=sk.make_fused_subcycle_cache(top, tail))
            fc = cs.time_ms(lambda: run_fixed_cycles(hh, torch.zeros_like(bf), bf, 50), reps=2) / 50
            print(f"round {rnd} {name:10s} tile {hh.sub.tile:3d}: fixed cycle {fc!r} ms", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: kernel_variants needs one")
        return 1
    mode = sys.argv[1] if sys.argv[1:] else ""
    variants = {"sweeps": SWEEP_VARIANTS, "subcycle": SUB_VARIANTS}.get(mode, VARIANTS)
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
        use("tree")
        ml = cs.setup(N)
        h = amt.build_device_hierarchy(ml, device="cuda", dtype=torch.float32)
        L0, L1 = h.levels[0], h.levels[1]
        gen = torch.Generator().manual_seed(0)

        def vec(m, length):
            v = torch.zeros(length)
            v[:m] = torch.randn(m, generator=gen)
            return v.cuda()

        x0, b0 = vec(N * N, h.fine_padded), vec(N * N, h.fine_padded)
        xc0 = vec(L0.R.shape[0], L0.R.shape[0])
        x1, b1 = vec(L1.A.shape[0], L1.A.rows_padded), vec(L1.A.shape[0], L1.A.rows_padded)
        xc1 = vec(L1.R.shape[0], L1.R.shape[0])
        bt = vec(h.levels[2].A.shape[0], h.levels[2].A.rows_padded)
        bf = torch.zeros(h.fine_padded, device="cuda")
        bf[: N * N] = torch.as_tensor(ml.levels[0].A @ np.ones(N * N), dtype=torch.float32, device="cuda")
        ref = vl.fused_updown_reference(L0.fused, x0, b0, xc0)
        for rnd in range(ROUNDS):
            for name in VARIANTS:
                use(name)
                err = max(cs.errors(g, r)[1] for g, r in zip(vl.fused_updown(L0.fused, x0, b0, xc0), ref))
                u0 = cs.time_ms(lambda: vl.fused_updown(L0.fused, x0, b0, xc0))
                u1 = cs.time_ms(lambda: vl.fused_updown(L1.fused, x1, b1, xc1))
                tl = cs.time_ms(lambda: tk.fused_tail(h.tail, torch.zeros_like(bt), bt, x_zero=True), reps=50)
                fc = cs.time_ms(lambda: run_fixed_cycles(h, torch.zeros_like(bf), bf, 50), reps=2) / 50
                print(f"round {rnd} {name:15s} K3 L0 {u0!r} ms  K3 L1 {u1!r} ms  K4 {tl!r} ms"
                      f"  fixed cycle {fc!r} ms  K3 max_rel_err {err!r}", flush=True)
        use("tree")
        legs0 = cs.time_ms(lambda: vl.fused_down(L0.fused, vl.fused_up(L0.fused, x0, b0, xc0), b0))
        legs1 = cs.time_ms(lambda: vl.fused_down(L1.fused, vl.fused_up(L1.fused, x1, b1, xc1), b1))
        print(f"K2 + K1: L0 {legs0!r} ms  L1 {legs1!r} ms")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
