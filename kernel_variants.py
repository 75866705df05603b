"""Time the cooperative kernels (K3 ``fused_updown``, K4 ``fused_tail``)
under alternative launch shapes and cell loops, on one NVIDIA card.

Each variant is the tree's CUDA sources with a few lines edited, built into
its own library (all builds run in parallel) and swapped in under the same
wrappers; the tree's own build is the variant ``tree``.  At 4096², in two
rounds, it prints each variant's K3 time at L0 (4096²) and L1 (1366²), its
K4 time (x = 0), one fixed cycle (``run_fixed_cycles``) and K3's error
against its plain version, then the same work through K2 + K1.  Run from the
repository root:

    python3 kernel_variants.py
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


def edit(text, old, new):
    if new is None:  # swap the for_cells loop for the row-chunk loop
        a = text.index("template <typename F>")
        b = text.index("// ---- host-side helpers")
        return text[:a] + CHUNK_LOOP + text[b:]
    if old not in text:
        raise SystemExit(f"variant edit no longer matches the source: {old!r}")
    return text.replace(old, new)


def build(root):
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    for name, edits in VARIANTS.items():
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: kernel_variants needs one")
        return 1
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
        build(root)
        print(f"{len(VARIANTS)} variants built in {time.perf_counter() - t!r} s", flush=True)

        def use(name):
            vl._lib = None
            vl.library_path = lambda: root / name / "lib.so"
            vl.load_library()

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
