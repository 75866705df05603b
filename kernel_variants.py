"""Time the tiled and cooperative kernels under alternative launch shapes,
tiles and barrier schemes, on one NVIDIA card: by default the updown leg
K3 (``fused_updown``) and the whole-tail kernel K4 (``fused_tail``); with
the argument ``sweeps``, the whole-sweep kernels K7 (``sweep3d``, at L0 of
256³, symmetric GS) and K5 (``gs_sweep``, at 4096², forward GS) under
alternative thread blocks and loaded boxes, and K7's march under
alternative plans and designs; with ``scan``, the natural-order sweep
``scan_gs`` under its routes and chain widths; with ``subcycle``, the
whole-subcycle kernel K9 (``fused_subcycle``, at L1 of 4096²) with its
levels tiled or pass by pass (``sub_grid_passes``) and under alternative
tile edges; with ``legs``, the down and up legs K1 (``fused_down``) and K2
(``fused_up``) at L0 and L1 of 4096² under alternative tiles, routes and
load phases; with ``against DIR``, this tree's library against the one
built from another checkout's sources in DIR (for example an unpacked
``git archive`` of the parent commit).

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

    python3 kernel_variants.py [legs [nf] | sweeps [march | march2d] | subcycle | scan | against DIR | sass DIR]

In ``sweeps`` mode each source variant runs K7's first design (the
halo-tile kernel) and K5 with each box of ``BOXES_3D`` / ``BOXES_2D`` (the
tile plus halo that ``tiled_sweep.plan_box`` starts from), and K7's march:
the tree under each plan of ``MARCH_VARIANTS`` (y-z box, segment length),
the ``march_*`` source variants (planes a batch, batches loaded ahead, one
cell a thread, b/dinv and the coefficient planes staged in rings rather
than read in place) under their ``MARCH_PLANS``, each with the error
against the plain version (``sweeps march``: the march's variants alone,
with the ``march_diag_*`` builds, diagnostics that drop its steps, loads or
step barriers to split its time).  ``sweeps march2d`` times K5's march at
L0 (4096², 5-point) and L1 (1366², 9-point) of the fwd/bwd hierarchy,
forward GS, f32: per source variant of ``MARCH2D_VARIANTS`` (the tree's
design, x alone in the ring; the coefficient planes, b and D⁻¹ staged in
rings by 16-byte ``cp.async``; a step's coefficients in registers a step
ahead; four cells a thread; batches of 2 or 8 rows; 512-thread blocks)
each strip and segment of ``MARCH2D_PLANS``, and the halo-tile kernel,
the variants in order and then in reverse.  Each distinct source compiles
once; a variant that fails to build is dropped with nvcc's output.  In
``scan`` mode ``scan_gs`` runs on the
natural-order levels of the scrambled 1024² problem, staged and streamed,
in the tree (a chain of 32 lanes) and the ``SCAN_VARIANTS`` (16, 8 or one
lane).  In ``subcycle`` mode each
source variant runs K9 with each tile edge of ``SUB_TILES`` (set as
``tail_kernel.TAIL_TILE``, cut to the register box by the plan), with the
error against the plain version, and a fixed cycle (``run_fixed_cycles``)
at the planned tiles.  In ``legs`` mode each source variant (which legs
read everything in their first memory phase: ``LEG_VARIANTS``) runs K1
from x and from zero and K2 under each tile of ``LEG_TILES``, one tile a
block and, for K2 where its stage fits, pipelined; then the legs pass by
pass; then K3, K4, a V-cycle and a fixed cycle with the planned tiles, and
K3 at L0 with bf16 planes on its staged route in turns with its tiles.
Then the non-factored K1 and K2 at L0/L1 of the 4096² NoSymmetry
hierarchy, bf16 and float32 planes, each tile of ``NF_LEG_TILES`` in
turns with their pass route, and the V-cycle with and without their
tiles; ``legs nf`` runs that alone, and the planned tiles of each
``NF_LEG_VARIANTS`` source edit (the plane-read loops) beside the tree's.
In ``against DIR`` mode the two libraries run the float32 and float64
K1 (from x and from zero), K2 and K3 at L0 and L1 of 1800² on their
planned routes and pass by pass, K4 (x read and from zero), K9 at L1, and
K5's and K7's marches (5-point 1800², 9-point 600², 96³; planned with the
tree's library) on the same inputs, and it prints whether each output is
bitwise equal;
then it times float32 K1–K4 at 4096² (L0 and L1 for the legs), a V-cycle
and a fixed cycle in turns (DIR, tree, tree, DIR).  DIR's library is
loaded without the entries it may lack (the bf16-plane ones, the
non-factored ones).  In ``sass DIR`` mode each source that differs from
DIR's is compiled on both sides and every kernel of DIR's compared
instruction by instruction (``cuobjdump -sass``).
"""

import ctypes
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


# K7's march designs that lost (sweep_march.cuh), as source edits: b and
# dinv, or also the coefficient planes, staged in rings beside x's by the
# same cp.async groups
MARCH_H = "sweep_march.cuh"
MARCH_RING_C = "(n_steps * p.reach[0] + (1 + kMarchDepth) * kMarchBatch)"
MARCH_LOAD_X = "      march_cp_async(xs + le[j], x_in + (in ? gm + lg[j] : 0), in);\n"
MARCH_UPDATE = "          xs[e] = xs[e] + omega * __ldg(dinv + gpl + ug[v]) * (__ldg(b + gpl + ug[v]) - acc);"
MARCH_SMEM = "  const size_t smem = march_smem_bytes(p.ext[0], p.ext[1], p.ring, (int)sizeof(T));"
MARCH_COEF = "if (k < n_off) acc += coef_ldg<T>(A, k * plane + gpl + ug[v]) * xr[xk[k] + e];"
# the edits that stage the coefficient planes in rings of the vectors' type
# take no bf16 planes: their variants drop K7's bf16 entry (``use`` loads
# such a library without it)
MARCH_NO_BF16 = [("sweep3d.cu", "AMG_SWEEP3D_MARCH_ENTRY(float, __nv_bfloat16, f32_bf16)\n", "")]


def march_staged(coef):
    """The edits that stage b and dinv (and with ``coef`` the coefficient
    planes) in a ring of their own."""
    arrays = "(2 + n_off)" if coef else "2"
    load = (MARCH_LOAD_X + "      if (in) {\n        T* cs = cr + ((m - L) % RC) * E + le[j];\n"
            "        march_cp_async(cs, dinv + gm + lg[j], true);\n"
            "        march_cp_async(cs + RC * E, b + gm + lg[j], true);\n"
            + ("        for (int q = 0; q < n_off; ++q) {\n"
               "          march_cp_async(cs + (2 + q) * RC * E, A + q * plane + gm + lg[j], true);\n"
               "        }\n" if coef else "")
            + "      }\n")
    edits = [
        (MARCH_H, "  T* xr = reinterpret_cast<T*>(march_smem);  // [RX][E]\n",
         "  T* xr = reinterpret_cast<T*>(march_smem);  // [RX][E]\n"
         f"  const int RC = {MARCH_RING_C.replace('n_steps', 'p.n_steps')};\n"
         "  T* cr = xr + RX * E;  // [arrays][RC][E]: dinv, b, the planes\n"),
        (MARCH_H, MARCH_LOAD_X, load),
        (MARCH_H, "          T acc = T(0);\n", "          const T* cs = cr + ((pl - L) % RC) * E + e;\n          T acc = T(0);\n"),
        (MARCH_H, MARCH_UPDATE, "          xs[e] = xs[e] + omega * cs[0] * (cs[RC * E] - acc);"),
        (MARCH_H, MARCH_SMEM, MARCH_SMEM.replace("p.ring,", f"p.ring + {arrays} * {MARCH_RING_C},")),
    ]
    if coef:
        edits.append((MARCH_H, MARCH_COEF,
                      "if (k < n_off) acc += cs[(2 + k) * RC * E] * xr[xk[k] + e];"))
        edits += MARCH_NO_BF16
    return edits


def march_batch(n):
    return [(MARCH_H, "constexpr int kMarchBatch = 4;", f"constexpr int kMarchBatch = {n};")]


# K5's 2-D march designs (sweeps march2d), as source edits of the tree's
# march (design a: x alone in the ring, the coefficient planes, b and dinv
# read in place by __ldg).  Design b stages dinv, b and the coefficient
# planes of each row over the strip in rings of their own, loaded with x's
# batch by 16-byte cp.async of the aligned superset of the strip's in-grid
# cells (zero-filled past each array's end); a staged row keeps the strip's
# alignment shift, so cell e of array q sits at e + shift_q(row).  Written
# for the 2-D view (o1 = 0, a 1 x E2 strip); the arrays' bases 16-byte
# aligned, as the caching allocator gives them.
MARCH_STAGE16 = [
    (MARCH_H, "__device__ __forceinline__ void march_commit() {",
     "__device__ __forceinline__ void march_cp_async16(void* dst, const void* src, int bytes) {\n"
     "  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);\n"
     "  asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16, %2;\\n\" ::\"r\"(d), \"l\"(src), \"r\"(bytes));\n"
     "}\n\n"
     "__device__ __forceinline__ void march_commit() {"),
    (MARCH_H, "  // plane m's x over the box into its ring slot, 0 outside the grid\n",
     "  constexpr int V = 16 / (int)sizeof(T);\n"
     "  const int RC = p.n_steps * r0 + (1 + kMarchDepth) * P;\n"
     "  const int ES = (E2 + V - 1) / V * V + 2 * V, NCH = ES / V, NA = 2 + n_off;\n"
     "  T* cr = xr + (RX * E + V - 1) / V * V;  // [NA][RC][ES]\n"
     "  auto arr = [&](int q) -> const T* { return q == 0 ? dinv : q == 1 ? b : A + (int64_t)(q - 2) * plane; };\n"
     "  auto stage_row = [&](int m) {\n"
     "    if (m < 0 || m >= n0) return;\n"
     "    const int slot = (m - L) % RC;\n"
     "    const int64_t row0 = (int64_t)m * pstride + o2;\n"
     "    const int64_t lo = row0 + max(-o2, 0), hi = (int64_t)m * pstride + min(o2 + E2, n2);\n"
     "    for (int i = tid; i < NA * NCH; i += nth) {\n"
     "      const int q = i / NCH, j = i - q * NCH;\n"
     "      const T* base = arr(q);\n"
     "      const uintptr_t end = (uintptr_t)(q < 2 ? base + plane : A + (int64_t)n_off * plane);\n"
     "      const uintptr_t ra = ((uintptr_t)base + (uintptr_t)(row0 * (int64_t)sizeof(T))) & ~(uintptr_t)15;\n"
     "      const uintptr_t src = ((uintptr_t)(base + lo) & ~(uintptr_t)15) + 16 * (uintptr_t)j;\n"
     "      if (src >= (uintptr_t)(base + hi)) continue;\n"
     "      const int bytes = end - src >= 16 ? 16 : (int)(end - src);\n"
     "      march_cp_async16(cr + ((int64_t)q * RC + slot) * ES + (src - ra) / sizeof(T), (const void*)src, bytes);\n"
     "    }\n"
     "  };\n\n"
     "  // plane m's x over the box into its ring slot, 0 outside the grid\n"),
    (MARCH_H, "      if (m0 + j < U) load(m0 + j);", "      if (m0 + j < U) {\n        load(m0 + j);\n        stage_row(m0 + j);\n      }"),
    (MARCH_H, "        const int64_t gpl = (int64_t)pl * pstride;\n",
     "        const int64_t gpl = (int64_t)pl * pstride;\n"
     "        const int sc = (pl - L) % RC;\n"
     "        int csh[KOFF + 2];\n"
     "#pragma unroll\n"
     "        for (int q = 0; q < KOFF + 2; ++q) {\n"
     "          const uintptr_t ra = (uintptr_t)arr(q) + (uintptr_t)((gpl + o2) * (int64_t)sizeof(T));\n"
     "          csh[q] = (int)(((int64_t)q * RC + sc) * ES) + (int)((ra & 15) / sizeof(T));\n"
     "        }\n"),
    (MARCH_H, MARCH_COEF,
     "if (k < n_off) acc += cr[csh[2 + k] + e] * xr[xk[k] + e];"),
    (MARCH_H, MARCH_UPDATE, "          xs[e] = xs[e] + omega * cr[csh[0] + e] * (cr[csh[1] + e] - acc);"),
    (MARCH_H, MARCH_SMEM,
     "  constexpr int V = 16 / (int)sizeof(T);\n"
     "  const size_t smem = march_smem_bytes(p.ext[0], p.ext[1], p.ring, (int)sizeof(T)) + 16 +\n"
     "      (size_t)(2 + n_off) * (n_steps * p.reach[0] + (1 + kMarchDepth) * kMarchBatch) *\n"
     "      ((p.ext[1] + V - 1) / V * V + 2 * V) * sizeof(T);"),
]
# design c: each step's coefficients, b and dinv for its P rows fetched into
# registers one step ahead (step 0's before the batch's wait and barrier,
# step s+1's before step s's barrier)
MARCH_REGS = [
    (MARCH_H, "    march_commit();\n    march_wait();\n    __syncthreads();\n",
     "    march_commit();\n"
     "    T cv[P][kMarchUnit][KOFF + 2];\n"
     "    auto fetch = [&](int s) {\n"
     "      const int l1 = (s + 1) * r1, l2 = (s + 1) * r2;\n"
     "      const int c = p.steps[s];\n"
     "      const bool row_in = ue1 >= l1 && ue1 < E1 - l1;\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < P; ++i) {\n"
     "        const int pl = M - (s + 1) * r0 - P + 1 + i;\n"
     "        if (!row_in || pl < L + (s + 1) * r0 || pl >= U - (s + 1) * r0 || pl < 0 || pl >= n0) continue;\n"
     "        const int ptab = (pl % p.per[0]) * percells;\n"
     "        const int64_t gpl = (int64_t)pl * pstride;\n"
     "#pragma unroll\n"
     "        for (int v = 0; v < kMarchUnit; ++v) {\n"
     "          const int e2 = ue2 + v;\n"
     "          if (!uin[v] || e2 < l2 || e2 >= E2 - l2 || p.tab[ptab + ucol[v]] != c) continue;\n"
     "#pragma unroll\n"
     "          for (int k = 0; k < KOFF; ++k) {\n"
     "            if (k < n_off) cv[i][v][k] = coef_ldg<T>(A, k * plane + gpl + ug[v]);\n"
     "          }\n"
     "          cv[i][v][KOFF] = __ldg(dinv + gpl + ug[v]);\n"
     "          cv[i][v][KOFF + 1] = __ldg(b + gpl + ug[v]);\n"
     "        }\n"
     "      }\n"
     "    };\n"
     "    fetch(0);\n"
     "    march_wait();\n"
     "    __syncthreads();\n"),
    (MARCH_H, "      for (int pl = M - (s + 1) * r0 - P + 1; pl <= M - (s + 1) * r0; ++pl) {\n",
     "      for (int i = 0; i < P; ++i) {\n        const int pl = M - (s + 1) * r0 - P + 1 + i;\n"),
    (MARCH_H, MARCH_COEF,
     "if (k < n_off) acc += cv[i][v][k] * xr[xk[k] + e];"),
    (MARCH_H, MARCH_UPDATE, "          xs[e] = xs[e] + omega * cv[i][v][KOFF] * (cv[i][v][KOFF + 1] - acc);"),
    (MARCH_H, "      }\n      __syncthreads();\n    }\n\n    // the planes M",
     "      }\n      if (s + 1 < S) fetch(s + 1);\n      __syncthreads();\n    }\n\n    // the planes M"),
]
GS_CU = "gs_sweep.cu"


def gs_batch(stencil, n):
    """K5's batch on the 5- or 9-point level set to n rows."""
    old = {5: "constexpr int kGsBatch5 = 2;", 9: "constexpr int kGsBatch9 = 4;"}[stencil]
    return [(GS_CU, old, old[:-2] + f"{n};")]


MARCH2D_VARIANTS = {
    "tree": [],
    "march2d_stage16": MARCH_STAGE16 + MARCH_NO_BF16,
    "march2d_regs": MARCH_REGS,
    "march2d_unit4": [(MARCH_H, "constexpr int kMarchUnit = 2;", "constexpr int kMarchUnit = 4;"),
                      (MARCH_H, "constexpr int kMarchCells = 3;", "constexpr int kMarchCells = 5;")],
    "march2d_p5_4": gs_batch(5, 4),
    "march2d_p9_2": gs_batch(9, 2),
    "march2d_p9_8": gs_batch(9, 8),
    # K7's bound on K5's blocks: 1024 threads, 64 registers a thread
    "march2d_threads1024": [(GS_CU, "constexpr int kGsMarchThreads = 512;", "constexpr int kGsMarchThreads = 1024;")],
}
# the planner's view of each source variant (tiled_sweep's constants)
MARCH2D_PLANNER = {
    "march2d_unit4": {"MARCH_UNIT": 4}, "march2d_p5_4": {"MARCH_BATCH_2D": {5: 4, 9: 4}},
    "march2d_p9_2": {"MARCH_BATCH_2D": {5: 2, 9: 2}}, "march2d_p9_8": {"MARCH_BATCH_2D": {5: 2, 9: 8}},
    "march2d_threads1024": {"MARCH_MAX_THREADS_2D": 1024},
}
# K5 at L0 (4096², 5-point, forward GS) and L1 (1366², 9-point, forward
# GS), f32: plans per source variant, by the keywords of
# tiled_sweep.plan_march (box: the 1 x E2 strip, tile plus 2 halo; seg: the
# rows a segment owns); {} is the planner's own.  Staged rings take 7 (11)
# arrays a row, so design b runs on narrower strips.
MARCH2D_PLANS = {
    "tree": {0: [{}, {"box": (1, 260)}, {"box": (1, 1028)}, {"seg": 18}, {"seg": 72}],
             1: [{}, {"box": (1, 350)}, {"box": (1, 691)}, {"seg": 4}, {"seg": 8}, {"seg": 16}, {"seg": 32}]},
    "march2d_stage16": {0: [{}, {"box": (1, 260)}], 1: [{"box": (1, 350)}, {"box": (1, 238)}]},
    "march2d_regs": {0: [{}], 1: [{}]},
    "march2d_unit4": {0: [{}, {"box": (1, 1028)}], 1: [{}]},
    "march2d_p5_4": {0: [{}, {"box": (1, 1028)}, {"seg": 18}]},
    "march2d_p9_2": {1: [{}, {"seg": 16}]},
    "march2d_p9_8": {1: [{}, {"seg": 16}]},
    "march2d_threads1024": {0: [{}, {"box": (1, 1028)}], 1: [{}, {"box": (1, 691)}]},
}


SWEEP_VARIANTS = {
    "tree": [],
    "march_batch1": march_batch(1),
    "march_batch2": march_batch(2),
    "march_depth2": [(MARCH_H, "constexpr int kMarchDepth = 1;", "constexpr int kMarchDepth = 2;")],
    "march_cells": [(MARCH_H, "constexpr int kMarchUnit = 2;", "constexpr int kMarchUnit = 1;")],
    "march_stage_rhs": march_batch(2) + march_staged(False),
    "march_stage_coef": march_batch(1) + march_staged(True),
    # diagnostics of K7's march, not designs (their results are wrong, their
    # errors say so): without its color steps, without its loads, or without
    # the barriers between steps, to split its time
    "march_diag_no_steps": [("sweep_march.cuh", "        if (!row_in || pl < L + (s + 1) * r0",
                             "        if (true || !row_in || pl < L + (s + 1) * r0")],
    "march_diag_no_loads": [("sweep_march.cuh", "      if (m0 + j < U) load(m0 + j);", "      if (false) load(m0 + j);")],
    "march_diag_no_step_barriers": [("sweep_march.cuh", "      }\n      __syncthreads();\n    }\n\n    // the planes M",
                                     "      }\n    }\n\n    // the planes M")],
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
# The non-factored tiles' plane reads (csrc/leg_tile.cuh): the tree loads
# the down tile's R planes kRBatch = 8 a batch and the up tile's P planes
# kPBatch = 2 a batch; the first design's plain loops (one plane an
# iteration, the R loop unrolled by 8); other batches.
NF_R_BATCHED = """    for (int q0 = 0; q0 < sr.n; q0 += kRBatch) {
      T rq[kRBatch], rr[kRBatch];
#pragma unroll
      for (int u = 0; u < kRBatch; ++u) {
        const int q = q0 + u < sr.n ? q0 + u : q0;
        rq[u] = coef_ldg<T>(Rp, q * cplane + cell);
        rr[u] = q0 + u < sr.n ? rc[sr.dx[q] * G1 + sr.dy[q]] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kRBatch; ++u) acc += rq[u] * rr[u];
    }
"""
NF_P_BATCHED = """  for (int q0 = 0; q0 < so.n; q0 += kPBatch) {
    T pv[kPBatch][CI][CJ];
#pragma unroll
    for (int u = 0; u < kPBatch; ++u) {
      const int64_t gq = (q0 + u < so.n ? q0 + u : q0) * plane;
#pragma unroll
      for (int a = 0; a < CI; ++a) {
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          const bool cell = in >> (a * CJ + c) & 1u;
          pv[u][a][c] = coef_ldg<T>(
              Pp, gq + (cell ? g0 + (int64_t)(WARPS * a) * L.Wy + 32 * c : 0));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kPBatch; ++u) {
      if (q0 + u >= so.n) break;
      const int dq = so.dx[q0 + u] * C1 + so.dy[q0 + u];
#pragma unroll
      for (int a = 0; a < CI; ++a) {
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          if (in >> (a * CJ + c) & 1u) {
            acc[a][c] += pv[u][a][c] * sm.sc[wc[a][c] + dq];
          }
        }
      }
    }
  }
"""
NF_R_PLAIN = """#pragma unroll 8
    for (int q = 0; q < sr.n; ++q) {
      acc += coef_ldg<T>(Rp, q * cplane + cell) * rc[sr.dx[q] * G1 + sr.dy[q]];
    }
"""
NF_P_PLAIN = """  for (int q = 0; q < so.n; ++q) {
    const int dq = so.dx[q] * C1 + so.dy[q];
    const int64_t gq = q * plane + g0;
#pragma unroll
    for (int a = 0; a < CI; ++a) {
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        if (in >> (a * CJ + c) & 1u) {
          acc[a][c] +=
              coef_ldg<T>(Pp, gq + (int64_t)(WARPS * a) * L.Wy + 32 * c) *
              sm.sc[wc[a][c] + dq];
        }
      }
    }
  }
"""
NF_BATCHES = "constexpr int kRBatch = 8, kPBatch = 2;"
NF_LEG_VARIANTS = {
    "nf_plain_loops": [("leg_tile.cuh", NF_R_BATCHED, NF_R_PLAIN), ("leg_tile.cuh", NF_P_BATCHED, NF_P_PLAIN)],
    "nf_p_batch3": [("leg_tile.cuh", NF_BATCHES, "constexpr int kRBatch = 8, kPBatch = 3;")],
    "nf_r_batch16": [("leg_tile.cuh", NF_BATCHES, "constexpr int kRBatch = 16, kPBatch = 2;")],
}
# the non-factored K1/K2 tiles per level and leg (the first is the plan's
# at 4096²; then the same area cut along x, and along y)
NF_LEG_TILES = {
    0: {"down": [(54, 54), (27, 54), (54, 27)], "up": [(57, 57), (30, 57), (57, 30)]},
    1: {"down": [(45, 45), (24, 45), (45, 24)], "up": [(48, 48), (24, 48), (48, 24)]},
}
SUB_VARIANTS = {
    "tree": [],
    "sub_grid_passes": [("tail_levels.cuh", "if (L.tile_x > 0) {", "if (false) {")],
}
SUB_TILES = (18, 27, 36, 45)
# (12, 12, 64) is lifted to (14, 14, 64): a one-step-per-halo tile keeps 8 cells
BOXES_3D = [(14, 14, 64), (20, 20, 64), (16, 16, 64), (24, 24, 64), (14, 16, 128), (32, 32, 32)]
BOXES_2D = [(1, 32, 64), (1, 64, 128), (1, 32, 128), (1, 16, 128), (1, 64, 64), (1, 16, 256)]
# K7's march at L0 of 256³ (sweeps mode): the tree under plans other than
# its own, by the keywords of tiled_sweep.plan_march (a y-z box whose ring
# or threads do not fit is cut by the plan) ...
MARCH_VARIANTS = [
    {}, {"box": (32, 32)}, {"box": (24, 64)}, {"box": (16, 128)}, {"box": (32, 96)}, {"seg": 26}, {"seg": 128},
]
# ... and the march_* source variants under theirs (default: the tree's);
# the planner does not know their rings or threads, so these boxes fit them
MARCH_PLANS = {
    "march_cells": [{"box": (16, 64)}, {"box": (32, 32)}],
    "march_stage_coef": [{"box": (32, 32)}, {"box": (16, 64)}],
}
# scan mode: the natural-order levels of the scrambled 1024² problem on the
# staged and streamed routes, per source variant: the chain in 16, 8 or
# one lane (the tree's in 32)
SCAN_VARIANTS = {"tree": []} | {
    f"lanes{k}": [("scan_gs.cu", "constexpr int kChainLanes = 32;", f"constexpr int kChainLanes = {k};")]
    for k in (16, 8, 1)
}


def edit(text, old, new):
    if old not in text:
        raise SystemExit(f"variant edit no longer matches the source: {old!r}")
    return text.replace(old, new)


def _included(d, name, seen=None):
    """The texts a source in directory d compiles: itself and the headers
    it includes, transitively."""
    seen = set() if seen is None else seen
    if name in seen or not (d / name).exists():
        return ""
    seen.add(name)
    text = (d / name).read_text()
    heads = [line.split('"')[1] for line in text.splitlines() if line.startswith('#include "')]
    return text + "".join(_included(d, h, seen) for h in heads)


def build(root, variants):
    """Each variant's library under root/<name>/lib.so: every distinct
    source (its text and the headers it includes) compiled once, all
    compiles started together, then one link a variant.  A variant that
    fails to build is dropped, with its compiler's output."""
    import hashlib

    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    objs, jobs = {}, {}
    for name, edits in variants.items():
        d = root / name
        d.mkdir()
        for f in vl.SOURCES + vl.HEADERS:
            text = f.read_text()
            for fname, old, new in edits:
                if fname == f.name:
                    text = edit(text, old, new)
            (d / f.name).write_text(text)
        for f in vl.SOURCES:
            key = hashlib.sha256(_included(d, f.name).encode()).hexdigest()[:16]
            obj = root / f"{f.stem}-{key}.o"
            objs.setdefault(name, []).append(obj)
            jobs.setdefault(obj, d / f.name)
    procs = {obj: subprocess.Popen(vl.compile_command(src, obj), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True) for obj, src in jobs.items()}
    failed = {obj for obj, pr in procs.items() if pr.wait()}
    for obj in failed:
        print(f"nvcc failed on {jobs[obj]}:\n{procs[obj].stdout.read()}", flush=True)
    built = {}
    for name, want in objs.items():
        if failed & set(want):
            print(f"variant {name} failed to build: dropped", flush=True)
            continue
        subprocess.run(vl.link_command(want, root / name / "lib.so"), check=True)
        built[name] = variants[name]
    if "tree" not in built:
        raise SystemExit("the tree's own sources failed to build")
    return built


def rel_err(got, want):
    """Max relative error, inf where a diagnostic's output is not finite."""
    got, want = got.double(), want.double()
    if not bool(got.isfinite().all()):
        return float("inf")
    return float((got - want).abs().max() / want.abs().max())


def march2d(use, names):
    """K5's 2-D march at L0 (4096², 5-point) and L1 (1366², 9-point),
    forward GS, f32: per source variant (``MARCH2D_VARIANTS``) each plan of
    ``MARCH2D_PLANS``, with the planner's constants as the variant needs
    them (``MARCH2D_PLANNER``), and the halo-tile kernel (K5's first design)
    in the tree; the variants in order, then in reverse order."""
    import dataclasses

    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.lattice import lattice_coloring
    from algebraicmultigrid_tpu_torch.ops.kernels import tiled_sweep as ts
    from algebraicmultigrid_tpu_torch.ops.kernels.gs_sweep import build_gs_sweep_cache, smooth_gs, smooth_gs_reference
    from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec

    import chip_smoke as cs

    gen = torch.Generator().manual_seed(0)
    nine = -np.ones((3, 3))
    nine[1, 1] = 8.0
    levels = {}
    for lvl, prob in ((0, amt.poisson((N, N), lattice=True)), (1, amt.LatticeProblem(nine, (1366, 1366)))):
        spec = prob.spec
        A = lat2d_from_spec(spec, torch.float32, "cuda", row_pad=8)
        tab, nc = lattice_coloring(spec)
        n = A.shape[0]
        dinv = torch.as_tensor(np.pad(1.0 / spec.diagonal(), (0, A.rows_padded - n)), dtype=torch.float32).cuda()
        x = torch.randn(A.rows_padded, generator=gen).cuda()
        b = torch.randn(A.rows_padded, generator=gen).cuda()
        c = build_gs_sweep_cache(A, dinv, tab, nc, 1.0, 1, True, False)
        levels[lvl] = (c, x, b, smooth_gs_reference(c, x, b))
        print(f"L{lvl} dims {c.dims} steps {c.steps} planned {c.march.args()} bound"
              f" {cs.bound(*cs.sweep_work(c), 4)}", flush=True)
    planner = {k: getattr(ts, k) for k in ("MARCH_BATCH_2D", "MARCH_UNIT", "MARCH_MAX_THREADS_2D")}
    for rnd in range(ROUNDS):
        for name in names if rnd % 2 == 0 else names[::-1]:
            use(name)
            for k, v in dict(planner, **MARCH2D_PLANNER.get(name, {})).items():
                setattr(ts, k, v)
            for lvl, (c0, x, b, want) in levels.items():
                for kw in MARCH2D_PLANS[name].get(lvl, []):
                    plan, why = ts.plan_march(c0.dims, c0.offsets, len(c0.steps), 4, device=x.device, **kw)
                    if plan is None:
                        print(f"round {rnd} {name:22s} L{lvl} {kw}: no plan ({why})", flush=True)
                        continue
                    c = dataclasses.replace(c0, march=plan)
                    try:
                        err = rel_err(smooth_gs(c, x, b), want)
                    except RuntimeError as e:  # a staged ring past the shared memory
                        print(f"round {rnd} {name:22s} L{lvl} {kw} plan {plan.args()}: {e}", flush=True)
                        continue
                    ms = cs.time_ms(lambda: smooth_gs(c, x, b))
                    print(f"round {rnd} {name:22s} L{lvl} {kw} plan {plan.args()}: {ms!r} ms  max_rel_err {err!r}",
                          flush=True)
                if name == "tree":  # K5's first design, the halo-tile kernel
                    ct = ts.tile_view(c0)
                    err = rel_err(smooth_gs(ct, x, b), want)
                    ms = cs.time_ms(lambda: smooth_gs(ct, x, b))
                    print(f"round {rnd} {'tile':22s} L{lvl} box {ct.box}: {ms!r} ms  max_rel_err {err!r}", flush=True)
    for k, v in planner.items():
        setattr(ts, k, v)


def sweeps(use, names, march_only=False):
    """K7's halo-tile route at 256³ and K5 at 4096², per source variant and
    box; K7's march at 256³ per plan variant (``march_only``: the march
    alone)."""
    import dataclasses

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
        if len(dims) == 3:
            c3, x3, b3 = build_c(A, dinv, tab, nc, 1.0, 1, *fwd_bwd), x, b
            want3 = ref(c3, x, b)
        for box in boxes:
            ts.BOX[len(dims)] = box
            c = ts.tile_view(build_c(A, dinv, tab, nc, 1.0, 1, *fwd_bwd))  # the halo-tile kernel
            cases.append((dims, box, c, fn, x, b, ref(c, x, b)))
    if march_only:
        cases = []
    for rnd in range(ROUNDS):
        for name in names:
            use(name)
            for dims, box, c, fn, x, b, want in cases:
                err = rel_err(fn(c, x, b), want)
                ms = cs.time_ms(lambda: fn(c, x, b))
                print(f"round {rnd} {name:16s} {dims} tile box {c.box}: {ms!r} ms  max_rel_err {err!r}", flush=True)
            # K7's march at L0 of 256³, symmetric GS
            for kw in MARCH_VARIANTS if name == "tree" else MARCH_PLANS.get(name, [{}]):
                plan, why = ts.plan_march(c3.dims, c3.offsets, len(c3.steps), 4, device=x3.device, **kw)
                if plan is None:
                    print(f"march {kw}: no plan ({why})", flush=True)
                    continue
                c = dataclasses.replace(c3, march=plan)
                err = rel_err(smooth_sweep3d(c, x3, b3), want3)
                ms = cs.time_ms(lambda: smooth_sweep3d(c, x3, b3))
                print(f"round {rnd} {name:16s} march {kw} plan {plan.args()}: {ms!r} ms  max_rel_err {err!r}",
                      flush=True)


def scan(use):
    """scan_gs on the natural-order levels of the scrambled 1024² problem,
    staged and streamed, per source variant."""
    import dataclasses

    import scipy.sparse as sp
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import ScanGSCache
    from algebraicmultigrid_tpu_torch.ops.kernels.scan_gs import smooth_scan_gs, smooth_scan_gs_reference

    import chip_smoke as cs

    use("tree")
    A = sp.csr_matrix(amt.poisson((cs.NU, cs.NU)))
    p = np.random.default_rng(cs.NU_SEED).permutation(A.shape[0])
    ml = amt.smoothed_aggregation(A[p][:, p].tocsr())
    h = amt.build_device_hierarchy(ml, device="cuda", dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    cases = []
    for lvl, L in enumerate(h.levels):
        if not isinstance(L.pre, ScanGSCache):
            continue
        c, sp_ = L.pre, L.pre.split
        x = torch.randn(L.A.rows_padded, generator=gen).cuda()
        b = torch.randn(L.A.rows_padded, generator=gen).cuda()
        want = smooth_scan_gs_reference(L.A, c.diag, x, b, c.omega, c.iter, c.forward, c.backward)
        splits = [("streamed", dataclasses.replace(sp_, route="streamed"))]
        if sp_.route == "staged":
            splits = [("staged", sp_)] + splits
        for label, split in splits:
            cases.append((lvl, L.A, dataclasses.replace(c, split=split), label, x, b, want))
    for rnd in range(ROUNDS):
        for name in SCAN_VARIANTS:
            use(name)
            for lvl, A_, c, label, x, b, want in cases:
                err = cs.errors(smooth_scan_gs(A_, c, x, b), want)[1]
                ms = cs.time_ms(lambda: smooth_scan_gs(A_, c, x, b))
                print(f"round {rnd} {name:8s} L{lvl} rows {A_.shape[0]} {label:15s}: {ms!r} ms  max_rel_err {err!r}",
                      flush=True)


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
    with the planned tiles; K3 at L0 with bf16 planes, staged and in tiles,
    in turns."""
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
    # K3 at L0 with bf16 planes (the benchmark's): staged and in tiles
    fb = amt.build_device_hierarchy(ml, device="cuda", dtype=torch.float32, coef_dtype=torch.bfloat16).levels[0].fused
    fb_tiles = dataclasses.replace(fb, updown_staged=False)

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
                        if key == "up" and vl.plan_up_pipelined(base):
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
            staged, tiles, turns = cs.in_turns(lambda: vl.fused_updown(fb, x0, b0, xc0),
                                               lambda: vl.fused_updown(fb_tiles, x0, b0, xc0))
            print(f"round {rnd} {name:10s} K3 L0 bf16 planes: staged {staged!r} ms (planned: {fb.updown_staged})"
                  f" tiles {tiles!r} ms (in turns, staged/tiles/tiles/staged: {turns!r})", flush=True)
    del h
    torch.cuda.empty_cache()
    legs_nf(use, ["tree"])


def legs_nf(use, names):
    """The non-factored K1 (from x and from zero) and K2 at L0/L1 of the
    4096² NoSymmetry hierarchy, float32 vectors under bf16 and float32
    planes, per source variant of ``names``: each tile of ``NF_LEG_TILES``
    (the tree; a variant, the planned tile) in turns with the pass route
    (pass, tile, tile, pass), with its error against the plain version;
    then the V-cycle with the planned tiles in turns with the one whose
    L0/L1 legs run pass by pass."""
    import dataclasses

    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    import chip_smoke as cs

    ml = cs.setup(N, symmetry=amt.NoSymmetry())
    gen = torch.Generator().manual_seed(1)

    def vec(m, length):
        v = torch.zeros(length)
        v[:m] = torch.randn(m, generator=gen)
        return v.cuda()

    for planes in ("bf16", "f32"):
        h = amt.build_device_hierarchy(ml, device="cuda", dtype=torch.float32,
                                       coef_dtype=torch.bfloat16 if planes == "bf16" else None)
        hp = dataclasses.replace(h, levels=tuple(
            dataclasses.replace(L, fused=dataclasses.replace(L.fused, down_tile=None, up_tile=None))
            if i < 2 else L for i, L in enumerate(h.levels)))
        bv = torch.zeros(h.fine_padded, device="cuda")
        bv[: N * N] = torch.as_tensor(ml.levels[0].A @ np.ones(N * N), dtype=torch.float32, device="cuda")
        xv = torch.zeros_like(bv)
        levels = []
        for lvl in (0, 1):
            L, f = h.levels[lvl], h.levels[lvl].fused
            assert not f.factored
            n, nc = L.A.shape[0], L.R.shape[0]
            x, b, xc = vec(n, L.A.rows_padded), vec(n, L.A.rows_padded), vec(nc, nc)
            calls = {
                "down": (lambda c, x=x, b=b: vl.fused_down(c, x, b), vl.fused_down_reference(f, x, b)),
                "down0": (lambda c, x=x, b=b: vl.fused_down(c, x, b, x_zero=True),
                          vl.fused_down_reference(f, x, b, x_zero=True)),
                "up": (lambda c, x=x, b=b, xc=xc: (vl.fused_up(c, x, b, xc),), (vl.fused_up_reference(f, x, b, xc),)),
            }
            levels.append((lvl, f, calls, dataclasses.replace(f, down_tile=None, up_tile=None)))
        for name in names:
            use(name)
            for lvl, f, calls, passed in levels:
                for leg, (fn, want) in calls.items():
                    key = "up" if leg == "up" else "down"
                    planned = getattr(f, f"{key}_tile")
                    for tile in NF_LEG_TILES[lvl][key] if name == "tree" else [planned]:
                        c = dataclasses.replace(f, **{f"{key}_tile": tile})
                        err = max(cs.errors(g, r)[1] for g, r in zip(fn(c), want))
                        pass_ms, ms, turns = cs.in_turns(lambda: fn(passed), lambda: fn(c))
                        print(f"nf {name} {planes} planes L{lvl} {f.row_dims} {leg:5s} tile {tile}: {ms!r} ms, pass"
                              f" route {pass_ms!r} ms (pass/tile/tile/pass {turns!r}) max_rel_err {err!r}"
                              f"{'  (planned)' if tile == planned else ''}", flush=True)
            pass_ms, ms, turns = cs.in_turns(lambda: _one_iteration(hp, amt.V(), xv, bv),
                                             lambda: _one_iteration(h, amt.V(), xv, bv), reps=10)
            print(f"nf {name} {planes} planes V-cycle: L0/L1 tiles {ms!r} ms, L0/L1 pass by pass {pass_ms!r} ms"
                  f" (pass/tiles/tiles/pass {turns!r})", flush=True)
        del h, hp, levels
        torch.cuda.empty_cache()


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


def against(other):
    """``against DIR`` mode (see the module docstring)."""
    import dataclasses

    import torch

    import algebraicmultigrid_tpu_torch as amt
    import chip_smoke as cs
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, run_fixed_cycles
    from algebraicmultigrid_tpu_torch.models.lattice import lattice_coloring
    from algebraicmultigrid_tpu_torch.models.lattice_nd import lattice_coloring_nd
    from algebraicmultigrid_tpu_torch.ops.kernels import gs_sweep as gs
    from algebraicmultigrid_tpu_torch.ops.kernels import subcycle_kernel as sk
    from algebraicmultigrid_tpu_torch.ops.kernels import sweep3d as s3
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.lattice_nd_op import latnd_from_spec
    from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec

    nine = -np.ones((3, 3))
    nine[1, 1] = 8.0
    tree = vl.load_library()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "other.so"
        csrc = Path(other) / "algebraicmultigrid_tpu_torch" / "csrc"
        vl.build_library(out, [csrc / f.name for f in vl.SOURCES if (csrc / f.name).exists()])
        # DIR's library without the entries it lacks (the bf16-plane ones, the non-factored ones)
        probe = ctypes.CDLL(str(out))
        saved = vl._BF16_ENTRIES, vl._SIGNATURES, vl._HELPERS, vl.library_path
        vl._BF16_ENTRIES, vl.library_path, vl._lib = {}, (lambda: out), None
        vl._SIGNATURES = {k: v for k, v in saved[1].items() if hasattr(probe, k.format("f32"))}
        vl._HELPERS = {k: v for k, v in saved[2].items() if hasattr(probe, k)}
        try:
            libs = {"other": vl.load_library(), "tree": tree}
        finally:
            vl._BF16_ENTRIES, vl._SIGNATURES, vl._HELPERS, vl.library_path = saved
            vl._lib = tree
    gen = torch.Generator().manual_seed(3)

    def vec(m, length, dtype=torch.float32):
        v = torch.zeros(length, dtype=dtype)
        v[:m] = torch.randn(m, generator=gen, dtype=dtype)
        return v.cuda()

    def run(name, fn):
        vl._lib = libs[name]
        got = fn()
        return got if isinstance(got, tuple) else (got,)

    same = []

    def bitwise(tag, fn):
        a, b = run("other", fn), run("tree", fn)
        torch.cuda.synchronize()
        same.append(all(torch.equal(u, v) for u, v in zip(a, b)))
        print(f"{tag}: {'bitwise equal' if same[-1] else 'DIFFERENT'}", flush=True)

    ml = cs.setup(1800)
    for dtype in (torch.float32, torch.float64):
        h = amt.build_device_hierarchy(ml, device="cuda", dtype=dtype)
        for lvl in (0, 1):
            L, f = h.levels[lvl], h.levels[lvl].fused
            n, pad, nc = L.A.shape[0], L.A.rows_padded, L.R.shape[0]
            x, b, xc = vec(n, pad, dtype), vec(n, pad, dtype), vec(nc, nc, dtype)
            for route, c in (("planned", f), ("pass", dataclasses.replace(f, down_tile=None, up_tile=None,
                                                                           up_pipelined=False))):
                for xz in (False, True):
                    bitwise(f"{dtype} L{lvl} K1 {route} x_zero={xz}", lambda: vl.fused_down(c, x, b, x_zero=xz))
                bitwise(f"{dtype} L{lvl} K2 {route}", lambda: vl.fused_up(c, x, b, xc))
            bitwise(f"{dtype} L{lvl} K3", lambda: vl.fused_updown(f, x, b, xc))
        L = h.levels[h.tail_start]
        x, b = vec(L.A.shape[0], L.A.rows_padded, dtype), vec(L.A.shape[0], L.A.rows_padded, dtype)
        for xz in (False, True):
            bitwise(f"{dtype} K4 x_zero={xz}", lambda: tk.fused_tail(h.tail, torch.zeros_like(x) if xz else x, b,
                                                                       x_zero=xz))
        hs = amt.build_device_hierarchy(ml, device="cuda", dtype=dtype, subcycle=True)
        L = hs.levels[hs.sub_start]
        b = vec(L.A.shape[0], L.A.rows_padded, dtype)
        bitwise(f"{dtype} K9 at L{hs.sub_start}", lambda: sk.fused_subcycle(hs.sub, b))
        del h, hs
        # K5's march (5- and 9-point Lat2D levels) and K7's (a 3-D LatND
        # level), planned with the tree's library
        for tag, prob, build, smooth in (
            ("K5 5-point 1800²", amt.poisson((1800, 1800), lattice=True), gs.build_gs_sweep_cache, gs.smooth_gs),
            ("K5 9-point 600²", amt.LatticeProblem(nine, (600, 600)), gs.build_gs_sweep_cache, gs.smooth_gs),
            ("K7 96³", amt.poisson((96,) * 3, lattice=True), s3.build_sweep3d_cache, s3.smooth_sweep3d),
        ):
            spec = prob.spec
            if len(spec.row_dims) == 3:
                A, (tab, nc) = latnd_from_spec(spec, dtype, "cuda"), lattice_coloring_nd(spec)
            else:
                A, (tab, nc) = lat2d_from_spec(spec, dtype, "cuda", row_pad=8), lattice_coloring(spec)
            dinv = torch.zeros(A.rows_padded, dtype=dtype)
            dinv[: A.shape[0]] = torch.as_tensor(1.0 / spec.diagonal(), dtype=dtype)
            c = build(A, dinv.cuda(), tab, nc, 1.0, 1, True, True)
            x, b = vec(A.shape[0], A.rows_padded, dtype), vec(A.shape[0], A.rows_padded, dtype)
            bitwise(f"{dtype} {tag} march {c.march.args()}", lambda: smooth(c, x, b))
    print(f"bitwise equal: {sum(same)} of {len(same)}", flush=True)

    ml = cs.setup(N)
    h = amt.build_device_hierarchy(ml, device="cuda", dtype=torch.float32)
    cases = []
    for lvl in (0, 1):
        L, f = h.levels[lvl], h.levels[lvl].fused
        n, pad, nc = L.A.shape[0], L.A.rows_padded, L.R.shape[0]
        x, b, xc = vec(n, pad), vec(n, pad), vec(nc, nc)
        cases += [(f"K1 L{lvl}", lambda f=f, x=x, b=b: vl.fused_down(f, x, b), 1),
                  (f"K2 L{lvl}", lambda f=f, x=x, b=b, xc=xc: vl.fused_up(f, x, b, xc), 1),
                  (f"K3 L{lvl}", lambda f=f, x=x, b=b, xc=xc: vl.fused_updown(f, x, b, xc), 1)]
    L = h.levels[h.tail_start]
    x4, b4 = vec(L.A.shape[0], L.A.rows_padded), vec(L.A.shape[0], L.A.rows_padded)
    bv = torch.zeros(h.fine_padded, device="cuda")
    bv[: N * N] = torch.as_tensor(ml.levels[0].A @ np.ones(N * N), dtype=torch.float32, device="cuda")
    xv = torch.zeros_like(bv)
    cases += [("K4", lambda: tk.fused_tail(h.tail, x4, b4), 1),
              ("V-cycle", lambda: _one_iteration(h, amt.V(), xv, bv), 1),
              ("fixed cycle", lambda: run_fixed_cycles(h, xv, bv, 50), 50)]
    for tag, fn, per in cases:
        t = [cs.time_ms(lambda: run(name, fn), 2 if per > 1 else cs.TIMED_REPS) / per
             for name in ("other", "tree", "tree", "other")]
        print(f"{tag} float32 4096²: DIR {(t[0] + t[3]) / 2!r} ms tree {(t[1] + t[2]) / 2!r} ms"
              f" (DIR/tree/tree/DIR {t!r})", flush=True)
    vl._lib = tree
    return 0 if all(same) else 1


def sass_against(other):
    """``sass DIR`` mode: every source whose text (with the headers it
    includes) differs between the tree and DIR compiled to a cubin for
    sm_90a on both sides and disassembled (``cuobjdump -sass``); prints,
    for each kernel DIR's source defines, whether the tree's has the same
    instructions (the anonymous namespace's name normalised).  Returns 0
    when every kernel of DIR is unchanged."""
    import re

    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    cuobjdump = str(Path(vl._nvcc()).with_name("cuobjdump"))
    tree_dir, other_dir = vl.CSRC, Path(other) / "algebraicmultigrid_tpu_torch" / "csrc"

    def kernels(cubin):
        text = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True, check=True).stdout
        out, name = {}, None
        for line in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                name = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "ANON", m.group(1))
                out[name] = []
            elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
                out[name].append(line.split("*/", 1)[1].split(";")[0].strip())
        return out

    same, changed = [], []
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for f in vl.SOURCES:
            if not (other_dir / f.name).exists():
                continue
            if _included(tree_dir, f.name) == _included(other_dir, f.name):
                print(f"{f.name}: the same source and headers", flush=True)
                continue
            for side, d in (("tree", tree_dir), ("other", other_dir)):
                out = Path(tmp) / f"{side}-{f.stem}.cubin"
                cmd = [vl._nvcc(), *vl._NVCC_FLAGS, "-cubin", str(d / f.name), "-o", str(out)]
                jobs[f.name, side] = (subprocess.Popen(cmd), out)
        if any(pr.wait() for pr, _ in jobs.values()):
            raise SystemExit("nvcc failed")
        for name in sorted({n for n, _ in jobs}):
            tree, base = kernels(jobs[name, "tree"][1]), kernels(jobs[name, "other"][1])
            for fn, code in base.items():
                (same if tree.get(fn) == code else changed).append(f"{name} {fn}")
            print(f"{name}: {sum(1 for fn in base if tree.get(fn) == base[fn])} of {len(base)} kernels with the same"
                  f" instructions; {len(tree) - len(base)} more kernels in the tree", flush=True)
    for c in changed:
        print(f"CHANGED: {c}", flush=True)
    print(f"same instructions: {len(same)} of {len(same) + len(changed)} kernels", flush=True)
    return 0 if not changed else 1


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: kernel_variants needs one")
        return 1
    mode = sys.argv[1] if sys.argv[1:] else ""
    if mode == "sass":
        return sass_against(sys.argv[2])
    if mode == "against":
        import chip_smoke as cs

        card = cs.card_line()
        print(f"card: {card}")
        rc = against(sys.argv[2])
        print(card)
        return rc
    variants = {"sweeps": SWEEP_VARIANTS, "subcycle": SUB_VARIANTS, "legs": LEG_VARIANTS,
                "scan": SCAN_VARIANTS}.get(mode, VARIANTS)
    march_only = mode == "sweeps" and sys.argv[2:] == ["march"]
    if march_only:
        variants = {k: v for k, v in variants.items() if k == "tree" or k.startswith("march")}
    if mode == "sweeps" and sys.argv[2:] == ["march2d"]:
        mode, variants = "march2d", MARCH2D_VARIANTS
    if mode == "legs" and sys.argv[2:] == ["nf"]:
        mode, variants = "legs_nf", {"tree": LEG_VARIANTS["tree"], **NF_LEG_VARIANTS}
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
        variants = build(root, variants)
        print(f"{len(variants)} variants built in {time.perf_counter() - t!r} s", flush=True)

        def use(name):
            vl._lib = None
            vl.library_path = lambda: root / name / "lib.so"
            entries = vl._BF16_ENTRIES
            if any(e in MARCH_NO_BF16 for e in variants[name]):
                vl._BF16_ENTRIES = {k: v for k, v in entries.items() if k != "amg_sweep3d_march_{}"}
            try:
                vl.load_library()
            finally:
                vl._BF16_ENTRIES = entries

        if mode == "march2d":
            march2d(use, list(variants))
            print(card)
            return 0
        if mode == "legs_nf":
            legs_nf(use, list(variants))
            print(card)
            return 0
        if mode == "sweeps":
            sweeps(use, list(variants), march_only)
            print(card)
            return 0
        if mode == "scan":
            scan(use)
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
