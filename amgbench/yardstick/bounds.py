"""Byte and operation counts of the V-cycle legs and the tail, and their
least time on the H100's published peaks.

A frozen copy of ``chip_smoke.py``'s ``_color_cells``, ``plane_words``,
``leg_work``, ``tail_work`` and ``bound`` (the arithmetic behind the bound
column of PERF.md's kernel table).  Each input is read once and each output
written once; planes count at their stored itemsize, so the same leg counts
the same bytes whatever kernel runs it.  A leg is any object with the
attributes of the program's leg cache (``A``, ``dinv``, ``T``, ``S``, ``R``,
``P``, ``offsA``, ``offsP``, ``offsR``, ``color_grid``, ``row_dims``,
``col_dims``, ``factored``, ``dtype``); a tail has ``levels`` and ``Mc``.
"""

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W: HBM
# bytes/s, and FLOP/s outside the tensor cores by the vectors' type
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12


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


def flops_rate(itemsize):
    """The published non-tensor-core rate for vectors of this itemsize."""
    return F64_FLOPS if itemsize == 8 else F32_FLOPS
