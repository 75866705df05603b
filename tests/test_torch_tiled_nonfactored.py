"""The tile plans of the non-factored legs (K1 ``fused_down`` and K2
``fused_up`` on a level with R and P planes, ``amg_fused_down_nf_*`` /
``amg_fused_up_nf_*``), checked on the CPU before any card, as
tests/test_torch_tiled_updown.py checks the factored ones: each planned
tile's box (the tile plus its halo, zero outside the grid) runs the plain
leg with the kernel's erosion rule, and the tiles stitched together equal
the plain leg on the whole grid bitwise in float64.

The down tile forms r = b − A·x on the tile plus the R offsets' spill
(``nf_spill``) from x exact on that area plus one reach (its halo
``nf_down_halo``), then its coarse cells' R-plane sums; the up tile
corrects its whole box with the P-plane sum over x_c staged on the box's
coarse window (``nf_window``), then steps (halo ``leg_halo``).  A halo
short by one cell, a window too small or a coarse cell summed by two tiles
shows here.  The grids are ragged (37 × 41, 64 × 70), k is 2 and 3, the
stencils 5- and 9-point, the R offsets the k-box dilated by the stencil,
the P offsets a cross or a box; and the real non-factored caches of the
192² NoSymmetry hierarchy."""

import math

import pytest
import torch

from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
from torch_port_common import (
    LEG_COLORS, LEG_OFFSETS, box_steps, boxed, inside, nf_offsets, setup_both, stitch_vectors, synthetic_nf_cache,
)


def run_nf_tiles(c, tile, leg, x, b, xc=None):
    """A non-factored leg tile by tile, stitched: ``leg`` "down" (x None:
    the zero start) or "up"; returns (x over the grid, b_c or None)."""
    Wx, Wy = c.row_dims
    Wxc, Wyc = c.col_dims
    k, reach = c.k, c.reach
    tx, ty = tile
    assert tx % k == 0 and ty % k == 0
    steps = c.steps
    down = leg == "down"
    sp = vl.nf_spill(c.offsR, k)
    h = vl.nf_down_halo(len(steps), reach, sp) if down else vl.leg_halo(len(steps), reach, False)
    E0, E1 = tx + 2 * h, ty + 2 * h
    B = b[: Wx * Wy].reshape(Wx, Wy)
    X0 = torch.zeros_like(B) if x is None else x[: Wx * Wy].reshape(Wx, Wy)
    XC = None if xc is None else xc[: Wxc * Wyc].reshape(Wxc, Wyc)
    out = torch.full((Wx, Wy), math.nan, dtype=B.dtype)
    bc = torch.full((Wxc, Wyc), math.nan, dtype=B.dtype)
    for ti in range(-(-Wx // tx)):
        for tj in range(-(-Wy // ty)):
            ox, oy = ti * tx - h, tj * ty - h
            ins = inside(ox, oy, E0, E1, c.row_dims)
            X = boxed(X0, ox, oy, E0, E1)
            if not down:
                X = torch.where(ins, X + box_correction(c, XC, ox, oy, E0, E1), X)
            X = box_steps(c, X, ox, oy, B, steps)
            i1, j1 = min(ti * tx + tx, Wx), min(tj * ty + ty, Wy)
            out[ti * tx : i1, tj * ty : j1] = X[h : h + i1 - ti * tx, h : h + j1 - tj * ty]
            if down:
                sums = tile_restrict_nf(c, X, ox, oy, B, h, sp, tile)
                I0, J0 = ti * tx // k, tj * ty // k
                I1, J1 = min(I0 + tx // k, Wxc), min(J0 + ty // k, Wyc)
                assert torch.isnan(bc[I0:I1, J0:J1]).all(), "a coarse cell lies in two tiles"
                bc[I0:I1, J0:J1] = sums[: I1 - I0, : J1 - J0]
    return vl._pad_out(out, b.shape[0]), bc.reshape(-1) if down else None


def box_correction(c, XC, ox, oy, E0, E1):
    """Σ_q P_q ⊙ x_c[⌊i/k⌋ + δ_q] over the box, x_c read from its coarse
    window as the kernel stages it (zero outside the coarse grid)."""
    k = c.k
    lo0, hi0, lo1, hi1 = vl.offset_span(c.offsP)
    C0, C1 = vl.nf_window(E0, k, lo0, hi0), vl.nf_window(E1, k, lo1, hi1)
    c0, c1 = ox // k + lo0, oy // k + lo1
    win = boxed(XC, c0, c1, C0, C1)
    ii = (ox + torch.arange(E0)) // k - c0
    jj = (oy + torch.arange(E1)) // k - c1
    P = boxed(c.P.to(XC.dtype), ox, oy, E0, E1)
    acc = None
    for q, (dx, dy) in enumerate(c.offsP):
        assert int(ii.min()) + dx >= 0 and int(ii.max()) + dx < C0, "the x_c window is too small"
        assert int(jj.min()) + dy >= 0 and int(jj.max()) + dy < C1, "the x_c window is too small"
        term = P[q] * win[ii + dx][:, jj + dy]
        acc = term if acc is None else acc + term
    return acc


def tile_restrict_nf(c, X, ox, oy, B, h, sp, tile):
    """The tile's coarse cells of b_c from r = b − A·x on the tile plus the
    spill (zero outside the grid): Σ_q R_q ⊙ r[k·c + δ_q]."""
    E0, E1 = X.shape
    k = c.k
    tx, ty = tile
    A, Bb = (boxed(v.to(X.dtype), ox, oy, E0, E1) for v in (c.A, B))
    ins = inside(ox, oy, E0, E1, c.row_dims)
    r = torch.where(ins, Bb - vl._stencil(A, X, c.offsA), 0.0)[h - sp : h + tx + sp, h - sp : h + ty + sp]
    kx, ky = tx // k, ty // k
    R = boxed(c.R.to(X.dtype), (ox + h) // k, (oy + h) // k, kx, ky)
    acc = None
    for q, (dx, dy) in enumerate(c.offsR):
        sub = r[sp + dx : sp + dx + k * (kx - 1) + 1 : k, sp + dy : sp + dy + k * (ky - 1) + 1 : k]
        assert sub.shape == (kx, ky), "r's area misses a coarse cell's fine cell"
        term = R[q] * sub
        acc = term if acc is None else acc + term
    return acc


def check_stitch(c, tile_down, tile_up, seed):
    """Both legs stitched against the plain versions, bitwise: the down leg
    from x and from zero, the up leg from x."""
    x, b, xc = stitch_vectors(c, seed)
    for x_zero in (False, True):
        got = run_nf_tiles(c, tile_down, "down", None if x_zero else x, b)
        ref = vl.fused_down_reference(c, x, b, x_zero=x_zero)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), x_zero
    got_x, _ = run_nf_tiles(c, tile_up, "up", x, b, xc)
    assert torch.equal(got_x, vl.fused_up_reference(c, x, b, xc))


CASES = [((37, 41), 3, 5), ((37, 41), 2, 9), ((64, 70), 3, 9), ((64, 70), 2, 5)]


@pytest.mark.parametrize("tiles", ["planned", "small"])
@pytest.mark.parametrize("p_offsets", ["cross", "box"])
@pytest.mark.parametrize("dims,k,n_off", CASES, ids=str)
def test_nf_tiles_stitch_to_the_plain_versions(dims, k, n_off, p_offsets, tiles):
    """The planned tiles, and small ones (many partial tiles and clipped
    coarse boxes), on synthetic levels."""
    c = synthetic_nf_cache(dims, k, n_off, seed=sum(dims) + k + n_off, p_offsets=p_offsets)
    assert not c.factored and c.updown_tile is None and not c.up_pipelined
    if tiles == "planned":
        tile_down, tile_up = c.down_tile, c.up_tile
        assert tile_down == vl.plan_down_nf(dims, k, c.offsA, c.offsR, len(c.steps))
        assert tile_up == vl.plan_up_nf(dims, k, c.offsA, len(c.steps))
    else:
        tile_down, tile_up = (6, 12), (12, 6)
    check_stitch(c, tile_down, tile_up, seed=n_off)


@pytest.fixture(scope="module")
def nosym_legs():
    """The port's non-factored leg caches of the 192² NoSymmetry problem."""
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy

    h = build_device_hierarchy(setup_both(nosym=True)[1], device="cpu", dtype=torch.float64, tail=False)
    return [L.fused for L in h.levels]


@pytest.mark.parametrize("lvl", [0, 1])
def test_nf_tiles_stitch_on_the_nosym_hierarchy(nosym_legs, lvl):
    """L0 (192², 5-point, 21 R / 5 P offsets) and L1 (64², 9-point, 25 /
    9) under their own plans."""
    c = nosym_legs[lvl]
    assert not c.factored and (len(c.offsA), len(c.offsR), len(c.offsP)) == ((5, 21, 5), (9, 25, 9))[lvl]
    assert c.down_tile is not None and c.up_tile is not None
    check_stitch(c, c.down_tile, c.up_tile, seed=10 + lvl)


@pytest.mark.parametrize("leg", ["down", "up"])
def test_an_nf_halo_short_by_one_cell_shows(leg, monkeypatch):
    """The stitch catches an under-sized halo: one cell less breaks it."""
    c = synthetic_nf_cache((37, 41), 3, 9, seed=3, p_offsets="box")
    x, b, xc = stitch_vectors(c, 3)
    if leg == "down":
        real = vl.nf_down_halo
        monkeypatch.setattr(vl, "nf_down_halo", lambda n, r, s: real(n, r, s) - 1)
        got = run_nf_tiles(c, (6, 12), "down", x, b)
        ref = vl.fused_down_reference(c, x, b)
        assert not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]))
    else:
        real = vl.leg_halo
        monkeypatch.setattr(vl, "leg_halo", lambda n, r, restriction: real(n, r, restriction) - 1)
        got_x, _ = run_nf_tiles(c, (6, 12), "up", x, b, xc)
        assert not torch.equal(got_x, vl.fused_up_reference(c, x, b, xc))


def nf_shape_cache(dims, k, n_off, iters=1):
    """A non-factored leg cache with the plans of a ``dims`` level and no
    planes (the plans read only shapes, offsets and steps)."""
    grid = LEG_COLORS[n_off]
    empty = torch.empty(0)
    offsR, offsP = nf_offsets(k, n_off, "cross" if n_off == 5 else "box")
    return vl.with_tile_plans(vl.FusedLegCache(
        A=empty, dinv=empty, T=None, S=None, R=empty, P=empty, offsR=offsR, offsP=offsP,
        offsA=LEG_OFFSETS[n_off], color_grid=grid, n_colors=len({c for row in grid for c in row}), k=k,
        row_dims=dims, col_dims=(-(-dims[0] // k), -(-dims[1] // k)), omega=1.0, iter=iters, forward=True,
        backward=True,
    ))


def test_nf_plans_on_the_flagship_shapes():
    """The flagship's non-factored levels get a tile: L0 (4096², k = 3,
    5-point, 21 R / 5 P offsets, 3 steps; R's spill 1, down halo 5, up
    halo 3) and L1 (1366², 9-point, 25 / 9, 7 steps; halos 9 and 7); each
    tile's shared memory fits a block at the vectors' itemsize (float32
    and bf16 planes under float32 vectors: 4; float64 and bf16 planes
    under float64: 8)."""
    L0, L1 = nf_shape_cache((4096, 4096), 3, 5), nf_shape_cache((1366, 1366), 3, 9)
    assert (len(L0.offsR), len(L0.offsP), len(L0.steps)) == (21, 5, 3)
    assert (len(L1.offsR), len(L1.offsP), len(L1.steps)) == (25, 9, 7)
    assert vl.nf_spill(L0.offsR, 3) == vl.nf_spill(L1.offsR, 3) == 1
    assert (L0.down_tile, L0.up_tile) == ((54, 54), (57, 57))  # boxes 64, 63
    assert (L1.down_tile, L1.up_tile) == ((45, 45), (48, 48))  # boxes 63, 62
    assert L0.updown_tile is None and not L0.up_pipelined
    for c in (L0, L1):
        n = len(c.steps)
        for itemsize in (4, 8):
            down = vl.nf_tile_smem_bytes(True, c.down_tile, n, c.reach, c.offsR, 3, itemsize)
            up = vl.nf_tile_smem_bytes(False, c.up_tile, n, c.reach, c.offsP, 3, itemsize)
            assert 0 < max(down, up) <= vl.SMEM_LIMIT - 2 * vl.DESC_BYTES
    # L0 float32: x over the 64² box, r over 56², a color byte a box cell
    assert vl.nf_tile_smem_bytes(True, (54, 54), 3, 1, L0.offsR, 3, 4) == (64 * 64 + 56 * 56) * 4 + 4096
    # L0's up box 63²: x_c over 21 + 1 + 2 = 24² coarse cells
    assert vl.nf_tile_smem_bytes(False, (57, 57), 3, 1, L0.offsP, 3, 4) == (63 * 63 + 24 * 24) * 4 + 3984


def test_nf_plan_limits():
    """No tile for a 13-point level, past 64 steps, or where no k × k tile's
    box fits; k = 2's spill from its dilated box."""
    offs13 = LEG_OFFSETS[9] + ((-2, 0), (2, 0), (0, -2), (0, 2))
    offsR2, _ = nf_offsets(2, 9, "box")
    assert vl.nf_spill(offsR2, 2) == 1
    assert vl.plan_down_nf((100, 100), 2, offs13, offsR2, 5) is None
    assert vl.plan_up_nf((100, 100), 2, offs13, 5) is None
    long = nf_shape_cache((40, 40), 2, 5, iters=40)
    assert len(long.steps) > vl.MAX_STEPS and long.down_tile is None and long.up_tile is None
    offsR3, _ = nf_offsets(3, 9, "box")
    assert vl.plan_down_nf((4096, 4096), 3, LEG_OFFSETS[9], offsR3, 29) is None  # halo 31: 2 cells < k
    assert vl.plan_down_nf((4096, 4096), 3, LEG_OFFSETS[9], offsR3, 28) == (3, 3)  # halo 30: 4 cells
    assert vl.plan_up_nf((4096, 4096), 3, LEG_OFFSETS[9], 31) is None  # halo 31
    assert vl.plan_up_nf((4096, 4096), 3, LEG_OFFSETS[9], 30) == (3, 3)  # halo 30
    # a wider R reach widens the spill and the halo
    assert vl.nf_spill(((0, 0), (-3, 0), (4, 0)), 2) == 3
