"""The tile plans of the tiled legs (K3 ``fused_updown``, K1
``fused_down`` and K2 ``fused_up``, and the grid levels of K4
``fused_tail`` and K9 ``fused_subcycle``), checked on the CPU
before any card: each planned tile's loaded box (the tile plus its halo,
zero outside the grid) runs the plain leg with the kernel's erosion rule
(step s updates only the cells at least (s+1)·reach inside the box), and
the tiles stitched together equal the plain leg on the whole grid
bitwise in float64.  A halo short by one reach, a tile that does not start
at a multiple of k, or a coarse cell summed by two tiles shows here.  The
grids are ragged (37 × 41, 64 × 70: partial last tiles and clipped coarse
boxes), k is 2 and 3, the stencils 5- and 9-point."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
from algebraicmultigrid_tpu_torch.ops.kernels.tiled_sweep import SMEM_LIMIT
from torch_port_common import (
    LEG_COLORS, LEG_OFFSETS, N, SETUP_KW, box_steps, boxed, inside, stitch_vectors as vectors,
    synthetic_leg_cache,
)

OFFS5, OFFS9 = LEG_OFFSETS[5], LEG_OFFSETS[9]


def leg_cache(dims, k, n_off, seed, iters=1):
    return synthetic_leg_cache(dims, k, n_off, seed, iters=iters)


def tile_restrict(c, X, ox, oy, B, h, tile):
    """b_c of the tile's coarse cells from x exact on the tile plus two
    reaches: r and g on the box (exact on the tile plus one reach), T·(r −
    A·g) on the tile, each coarse cell's k × k sum."""
    E0, E1 = X.shape
    A, Bb, S, T = (boxed(v, ox, oy, E0, E1) for v in (c.A, B, c.S, c.T))
    ins = inside(ox, oy, E0, E1, c.row_dims)
    r = torch.where(ins, Bb - vl._stencil(A, X, c.offsA), 0.0)
    g = torch.where(ins, S * r, 0.0)
    tx, ty = tile
    ts = (T * (r - vl._stencil(A, g, c.offsA)))[h : h + tx, h : h + ty]
    ts = torch.where(ins[h : h + tx, h : h + ty], ts, 0.0)
    k = c.k
    return ts.reshape(tx // k, k, ty // k, k).sum(dim=1).sum(dim=2)


def run_tiles(c, tile, leg, x, b, xc=None):
    """The leg tile by tile, stitched: ``leg`` is "updown", "down" (x None:
    the zero start) or "up"; returns (x over the grid, b_c or None)."""
    Wx, Wy = c.row_dims
    Wxc, Wyc = c.col_dims
    k, r_ = c.k, c.reach
    tx, ty = tile
    assert tx % k == 0 and ty % k == 0
    steps = c.steps2 if leg == "updown" else c.steps
    h = vl.leg_halo(len(steps), r_, leg != "up")
    B = b[: Wx * Wy].reshape(Wx, Wy)
    X0 = torch.zeros_like(B) if x is None else x[: Wx * Wy].reshape(Wx, Wy)
    if xc is not None:
        X0 = vl._correct(c, X0, xc)
    out = torch.full((Wx, Wy), math.nan, dtype=B.dtype)
    bc = torch.full((Wxc, Wyc), math.nan, dtype=B.dtype)
    for ti in range(-(-Wx // tx)):
        for tj in range(-(-Wy // ty)):
            ox, oy = ti * tx - h, tj * ty - h
            X = box_steps(c, boxed(X0, ox, oy, tx + 2 * h, ty + 2 * h), ox, oy, B, steps)
            i1, j1 = min(ti * tx + tx, Wx), min(tj * ty + ty, Wy)
            out[ti * tx : i1, tj * ty : j1] = X[h : h + i1 - ti * tx, h : h + j1 - tj * ty]
            if leg != "up":
                sums = tile_restrict(c, X, ox, oy, B, h, tile)
                I0, J0 = ti * tx // k, tj * ty // k
                I1, J1 = min(I0 + tx // k, Wxc), min(J0 + ty // k, Wyc)
                assert torch.isnan(bc[I0:I1, J0:J1]).all(), "a coarse cell lies in two tiles"
                bc[I0:I1, J0:J1] = sums[: I1 - I0, : J1 - J0]
    x_out = vl._pad_out(out, b.shape[0])
    return x_out, None if leg == "up" else bc.reshape(-1)


CASES = [((37, 41), 3, 5), ((37, 41), 2, 9), ((64, 70), 3, 9), ((64, 70), 2, 5)]
TILES = [(6, 12), (12, 6), "planned"]


def _tile(c, want, leg):
    """A given tile; "planned": K3's plan, or the tail's for a grid level
    of this shape (both legs); "legs": K1's or K2's plan."""
    if want == "legs":
        return {"down": c.down_tile, "up": c.up_tile}[leg]
    if want != "planned":
        return want
    if leg == "updown":
        return c.updown_tile
    return vl.plan_tile(c.row_dims, c.k, len(c.offsA), vl.leg_halo(len(c.steps), c.reach, True), tk.TAIL_TILE)


@pytest.mark.parametrize("want", TILES, ids=str)
@pytest.mark.parametrize("dims,k,n_off", CASES, ids=str)
def test_updown_tiles_stitch_to_the_plain_version(dims, k, n_off, want):
    c = leg_cache(dims, k, n_off, seed=sum(dims) + k + n_off)
    tile = _tile(c, want, "updown")
    x, b, xc = vectors(c, 1)
    got_x, got_bc = run_tiles(c, tile, "updown", x, b, xc)
    ref_x, ref_bc = vl.fused_updown_reference(c, x, b, xc)
    assert torch.equal(got_x, ref_x)
    assert torch.equal(got_bc, ref_bc)


@pytest.mark.parametrize("want", TILES + ["legs"], ids=str)
@pytest.mark.parametrize("dims,k,n_off", CASES, ids=str)
def test_tail_leg_tiles_stitch_to_the_plain_versions(dims, k, n_off, want):
    """The tiled down and up legs (K1 and K2 under their own plans, "legs";
    K4's and K9's grid levels): the down leg from x and from zero, the up
    leg from x_mid."""
    c = leg_cache(dims, k, n_off, seed=2 * sum(dims) + k + n_off)
    tile_down, tile_up = _tile(c, want, "down"), _tile(c, want, "up")
    assert tile_down[0] > 0 and tile_up[0] > 0
    x, b, xc = vectors(c, 2)
    for x_zero in (False, True):
        got = run_tiles(c, tile_down, "down", None if x_zero else x, b)
        ref = vl.fused_down_reference(c, x, b, x_zero=x_zero)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    got_x, _ = run_tiles(c, tile_up, "up", x, b, xc)
    assert torch.equal(got_x, vl.fused_up_reference(c, x, b, xc))


def test_a_halo_short_by_one_reach_shows():
    """The check above catches an under-sized halo: one reach less breaks
    the stitched result."""
    c = leg_cache((37, 41), 3, 9, seed=3)
    x, b, xc = vectors(c, 3)
    real = vl.leg_halo
    try:
        vl.leg_halo = lambda n, r, restriction: real(n, r, restriction) - r
        got_x, got_bc = run_tiles(c, (6, 12), "updown", x, b, xc)
    finally:
        vl.leg_halo = real
    ref_x, ref_bc = vl.fused_updown_reference(c, x, b, xc)
    assert not (torch.equal(got_x, ref_x) and torch.equal(got_bc, ref_bc))


def test_updown_plan_limits():
    """The plan: tiles in multiples of k within the grid, the box (tile +
    2·halo) within the register map's 64 cells a side; none for a stencil
    of other than 5 or 9 points, past 64 steps, or where no k × k tile's
    box fits."""
    assert vl.plan_updown((4096, 4096), 3, OFFS5, 5) == (48, 48)  # box 62
    assert vl.plan_updown((1366, 1366), 3, OFFS9, 13) == (33, 33)  # box 63
    assert vl.plan_updown((37, 41), 3, OFFS5, 5) == (39, 42)
    assert vl.plan_updown((4096, 4096), 2, OFFS5, 5) == (48, 48)  # box 62
    assert vl.plan_updown((4096, 4096), 2, OFFS9, 29) == (2, 2)  # box 2 + 62
    # 13 points (L1 of a box-2 hierarchy): K2 then K1, whatever the steps
    offs13 = OFFS9 + ((-2, 0), (2, 0), (0, -2), (0, 2))
    for steps in (1, 5, 29):
        assert vl.plan_updown((100, 100), 2, offs13, steps) is None
    assert vl.plan_updown((4096, 4096), 3, OFFS9, 29) is None  # 2 cells left < k
    assert vl.plan_updown((4096, 4096), 3, OFFS5, 65) is None
    assert vl.plan_updown((4096, 4096), 3, OFFS9, 64) is None
    assert vl.plan_tile((4096, 4096), 3, 9, 31, (48, 48)) is None
    assert vl.plan_tile((200_000, 10), 2, 5, 7, (2, 2)) is None  # 100k tile rows
    long = leg_cache((40, 40), 2, 5, seed=1, iters=16)
    assert len(long.steps2) == 65 and long.updown_tile is None
    e, up, rg = 62 * 62, 64 * 64, 2 * 50 * 50
    colors = 3856  # a byte a box cell, to 16 bytes
    assert vl.tile_smem_bytes(48, 48, 7, 1, 4) == (e + max(up, rg)) * 4 + colors


def shape_cache(dims, k, n_off, dtype=torch.float32):
    """A leg cache with the plans of a ``dims`` level and no planes (the
    plans read only shapes, stencil, steps and the itemsize)."""
    grid = LEG_COLORS[n_off]
    empty = torch.empty(0, dtype=dtype)
    return vl.with_tile_plans(vl.FusedLegCache(
        A=empty, dinv=empty, T=empty, S=empty, offsA=LEG_OFFSETS[n_off], color_grid=grid,
        n_colors=len({c for row in grid for c in row}), k=k, row_dims=dims,
        col_dims=(-(-dims[0] // k), -(-dims[1] // k)), omega=1.0, iter=1, forward=True, backward=True,
    ))


def test_leg_plan_limits():
    """K1's and K2's plans: the down leg's box (tile + 2·halo) and the up
    leg's box plus one reach (its Tup area) within the register map's 64
    cells a side; K2 pipelined only on 5-point levels in float32, where
    its stage and tile buffers fit a block; none past 64 steps, for 13
    points, or where no k × k tile's box fits."""
    L0 = shape_cache((4096, 4096), 3, 5)  # the flagship's L0: 3 steps
    assert len(L0.steps) == 3 and (L0.down_tile, L0.up_tile) == ((54, 54), (54, 54))  # boxes 64, 60 (+2)
    assert L0.up_pipelined
    # A, dinv, b, x, S over the box; T over the box plus one reach; x_c under it
    stage = ((5 + 4) * 60 * 60 + 62 * 62 + 22 * 22) * 4
    assert vl.stage_bytes((60, 60), 5, 1, 3, 4) == stage
    assert stage + vl.tile_smem_bytes(54, 54, 3, 1, 4) <= vl.SMEM_LIMIT - vl.DESC_BYTES
    assert not shape_cache((4096, 4096), 3, 5, torch.float64).up_pipelined
    L1 = shape_cache((1366, 1366), 3, 9)  # L1: 7 steps
    assert len(L1.steps) == 7 and (L1.down_tile, L1.up_tile) == ((45, 45), (48, 48))  # boxes 63, 62 (+2)
    assert not L1.up_pipelined
    assert vl.plan_down((37, 41), 2, OFFS5, 3) == (38, 42)
    assert vl.plan_up((64, 70), 2, OFFS9, 7) == (48, 48)
    offs13 = OFFS9 + ((-2, 0), (2, 0), (0, -2), (0, 2))
    assert vl.plan_down((100, 100), 2, offs13, 5) is None and vl.plan_up((100, 100), 2, offs13, 5) is None
    assert vl.plan_down((4096, 4096), 3, OFFS5, 65) is None and vl.plan_up((4096, 4096), 3, OFFS5, 65) is None
    assert vl.plan_down((4096, 4096), 3, OFFS9, 29) is None  # halo 31: 2 cells left < k
    assert vl.plan_up((4096, 4096), 3, OFFS9, 30) is None  # Tup area: 64 - 2·31 < k
    assert vl.plan_up((4096, 4096), 2, OFFS9, 30) == (2, 2)


def test_updown_staged_plan_at_the_flagship_shapes():
    """K3's staged route (csrc/updown_stage.cuh, the next tile's box landing
    by TMA): the flagship's L0 (4096², 5-point, tile 48, box 62) with bf16
    planes under float32 vectors; not with float32 planes (the staged
    route takes bf16 planes only), nor L1 (1366², 9-point)."""
    L0 = shape_cache((4096, 4096), 3, 5)
    assert L0.updown_tile == (48, 48) and not L0.updown_staged
    bf = vl.round_planes(L0, torch.bfloat16)
    assert bf.updown_tile == (48, 48) and bf.dtype == torch.float32 and bf.updown_staged
    L1 = vl.round_planes(shape_cache((1366, 1366), 3, 9), torch.bfloat16)
    assert L1.updown_tile == (33, 33) and not L1.updown_staged


def test_updown_stage_fits_shared_memory():
    """The staged K3's stage at the flagship's box, rows of 72 cells (64
    and a skew of up to 7) and each array to 128 bytes: A (5 planes) and
    D⁻¹ in bf16, b and x in float32, x_c's 23 × 23 coarse cells, two slots
    of S (62 rows) and T (64 rows); with the tile buffers and the kernel's
    alignment within a block's shared memory, in bf16 only.  Every box a
    5-point plan can stage fits."""
    to128 = lambda v: -(-v // 128) * 128
    plane, vec, tarea = 62 * 72 * 2, 62 * 72 * 4, 64 * 72 * 2
    want = 0
    for size in (5 * plane, plane, vec, vec, 23 * 23 * 4, plane, tarea, plane, tarea):
        want = to128(want + size)
    assert vl.STAGE_ROW == 72 and vl.updown_stage_bytes((62, 62), 1, 3, 2, 4) == want == 128_000
    limit = vl.SMEM_LIMIT - vl.DESC_BYTES
    tile = vl.tile_smem_bytes(48, 48, 7, 1, 4)
    assert vl.STAGE_ALIGN + want + tile <= limit < vl.STAGE_ALIGN + vl.updown_stage_bytes((62, 62), 1, 3, 4, 4) + tile
    for k in (2, 3):
        for n2 in range(1, 30):
            t = vl.plan_updown((4096, 4096), k, OFFS5, n2)
            h = vl.leg_halo(n2, 1, True)
            if t is None or max(t) + 2 * h + 2 > vl.REG_BOX:
                continue
            box = (t[0] + 2 * h, t[1] + 2 * h)
            assert vl.STAGE_ALIGN + vl.updown_stage_bytes(box, 1, k, 2, 4) + vl.tile_smem_bytes(*t, h, 1, 4) <= limit


def _unaligned(t):
    """t's values in a tensor whose data starts 2 bytes past an aligned one."""
    raw = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = raw[1:].view(t.shape)
    out.copy_(t)
    return out


STAGED_REFUSALS = {
    "float64 vectors": lambda: vl.round_planes(shape_cache((4096, 4096), 3, 5, torch.float64), torch.bfloat16),
    "bf16 rows not a multiple of 16 bytes": lambda: vl.round_planes(shape_cache((4100, 4100), 3, 5), torch.bfloat16),
    "9 points": lambda: vl.round_planes(shape_cache((4096, 4096), 3, 9), torch.bfloat16),
    "no K3 tile": lambda: leg_cache((40, 40), 2, 5, seed=1, iters=16),
    "Tup area past the thread map": lambda: vl.round_planes(vl.with_tile_plans(dataclasses.replace(
        shape_cache((4096, 4096), 3, 5), iter=2)), torch.bfloat16),
    "non-contiguous planes": lambda: _replanned(lambda c: dict(A=c.A.transpose(1, 2).contiguous().transpose(1, 2))),
    "unaligned planes": lambda: _replanned(lambda c: dict(S=_unaligned(c.S))),
    "float32 planes": lambda: synthetic_leg_cache((32, 40), 2, 5, seed=1, dtype=torch.float32),
    "float32 planes at the flagship's box": lambda: shape_cache((4096, 4096), 3, 5),
}


def _replanned(change):
    c = synthetic_leg_cache((64, 72), 3, 5, seed=1, dtype=torch.float32, coef_dtype=torch.bfloat16)
    assert c.updown_staged
    return vl.with_tile_plans(dataclasses.replace(c, **change(c)))


@pytest.mark.parametrize("case", list(STAGED_REFUSALS))
def test_updown_staged_plan_refusals(case):
    """Levels the staged K3 refuses keep the tiled K3 (one block a tile)."""
    c = STAGED_REFUSALS[case]()
    assert not c.updown_staged and c.plane_maps is None
    if case == "no K3 tile":
        assert c.updown_tile is None
    elif case == "Tup area past the thread map":
        assert c.updown_tile == (42, 42) and len(c.steps2) == 9  # box 64, Tup area 66
    elif case == "float32 planes":
        # the box (46 × 54) and its stage fit: refused for the planes' dtype alone
        assert c.updown_tile == (32, 40) and vl.plan_updown_staged(vl.round_planes(c, torch.bfloat16))
        box, h = (46, 54), 7
        assert vl.STAGE_ALIGN + vl.updown_stage_bytes(box, 1, 2, 4, 4) + vl.tile_smem_bytes(
            32, 40, h, 1, 4) <= vl.SMEM_LIMIT - vl.DESC_BYTES
    else:
        assert c.updown_tile is not None


def test_updown_staged_plan_survives_convert():
    """The plan is made where the other tiles are (``with_tile_plans``): a
    leg cache carried across from numpy arrays by ``convert`` keeps it."""
    from algebraicmultigrid_tpu_torch import convert

    c = synthetic_leg_cache((64, 72), 3, 5, seed=2, dtype=torch.float32)
    d = {name: getattr(c, name).numpy() for name in ("A", "dinv", "T", "S")}
    d.update(offsA=c.offsA, color_grid=c.color_grid, n_colors=c.n_colors, k=c.k, row_dims=c.row_dims,
             col_dims=c.col_dims, omega=c.omega, iter=c.iter, forward=c.forward, backward=c.backward)
    f32 = convert._fused(d, torch.float32, "cpu")
    bf = convert._fused(d, torch.float32, "cpu", coef_dtype=torch.bfloat16)
    assert f32.updown_tile == bf.updown_tile == c.updown_tile
    assert bf.A.dtype == torch.bfloat16 and bf.updown_staged and not f32.updown_staged
    assert bf.plane_maps is None  # the tensor maps are encoded for planes on the card only


def test_register_boxes_fit_shared_memory():
    """Every tile the plans can give (a box of at most 64 cells a side, any
    halo, reach up to 10, float64), with the largest descriptor table of the
    whole-tail kernels, fits an H100 block's shared memory."""
    worst = 0
    for reach in range(1, 11):
        for n in range(1, vl.MAX_STEPS + 1):
            halo = vl.leg_halo(n, reach, True)
            side = vl.REG_BOX - 2 * halo
            if side >= 2:
                worst = max(worst, vl.tile_smem_bytes(side, side, halo, reach, 8))
    table = 17 * 1024  # 17 LevelDesc of < 1 KB (checked on the card)
    assert 0 < worst and worst + table <= SMEM_LIMIT


def test_tail_tiles_on_the_flagship_shapes():
    """The tail's plan at 4096²: 456² and 153² tiled (9-point, 7 steps, the
    box within the register path's 64 cells a side), 51² and below pass by
    pass in one block."""
    levels = [leg_cache((n, n), 3, 9, seed=n) for n in (456, 153, 51, 17)]
    tiles = tk.tail_tiles(levels)
    assert tiles == ((45, 45), (45, 45), (0, 0), (0, 0))
    halo = vl.leg_halo(len(levels[0].steps), 1, True)
    assert tk.tail_smem(levels, tiles) == vl.tile_smem_bytes(45, 45, halo, 1, 8)


def test_fixed_cycles_past_the_plan_run_up_then_down():
    """A top level past K3's plan (17 symmetric GS sweeps: 69 steps in the
    double sweep) runs K2 then K1 in the fixed-cycle loop, with the same
    cycles as the iterated V-cycle."""
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.config import GaussSeidel
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy, run_fixed_cycles

    gs = GaussSeidel(ordering="multicolor", iter=17)
    ml = amt.structured_smoothed_aggregation(
        amt.poisson((N, N), lattice=True), aggregate=amt.StructuredAggregation(box=3), presmoother=gs,
        postsmoother=gs, **SETUP_KW,
    )
    h = build_device_hierarchy(ml, device="cpu", dtype=torch.float64, tail_max_rows=5000)
    assert h.levels[0].fused is not None and h.levels[0].fused.updown_tile is None
    # nor a tail: the 9-point levels' legs have 103 color steps, past the
    # tail kernel's 64
    assert h.tail is None and len(h.levels[1].fused.steps) == 103
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(h.fine_padded))
    b[N * N :] = 0
    got = run_fixed_cycles(h, torch.zeros_like(b), b, 3)
    x = torch.zeros_like(b)
    for _ in range(3):
        x = _one_iteration(h, amt.V(), x, b)
    assert torch.equal(got, x)
