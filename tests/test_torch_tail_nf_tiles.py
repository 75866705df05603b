"""The whole-tail kernel K4 on non-factored levels in tiles
(``amg_fused_tail_nf_*``), checked on the CPU before any card.

A grid level of a non-factored tail (more than ``BLOCK_CELLS`` cells) runs
each leg as one phase of tiles: K1's non-factored down tile (x to the
level's x_mid, the tile's coarse cells of b_c) and K2's up tile (from
x_mid), each from its own plan (``tail_tiles``, ``tail_up_tiles``).  Here
the tail's plan at the 4096² NoSymmetry shapes, and a whole tail V-cycle
run tile by tile (the box emulation and stitch of
tests/test_torch_tiled_nonfactored.py, R at the working dtype as the tail
keeps it) against ``fused_tail_reference``, bitwise in float64; a halo
short by one cell breaks it.

The hierarchy is the 192² NoSymmetry problem (the smallest grids the
structured setup keeps as lattices: below ~150² its proxy path falls back
to CSR levels, tests/test_torch_setup.py), its tail from L0 (192², 5-point,
tiled by the plan) or from L1 (64², 22², 8²: no level the plan tiles),
through ``build_fused_tail_cache``'s ``max_rows``."""

import dataclasses

import pytest
import torch

import algebraicmultigrid_tpu_torch as amt
from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
from test_torch_tiled_nonfactored import nf_shape_cache, run_nf_tiles
from torch_port_common import N, SETUP_KW, stitch_vectors

# the 4096² NoSymmetry hierarchy's tail (L2 … L6, 9-point, box 3) and its
# 2 × 2 coarse grid
FLAGSHIP_TAIL = (456, 153, 51, 17, 6)
FLAGSHIP_COARSE = (2, 2)
# the tail of the 192² problem from L0 (all its rows) or from L1
TAIL_ROWS = {0: N * N, 1: 5000}
# small tiles (many partial tiles, clipped coarse boxes) for the down and up legs
SMALL = ((6, 12), (12, 6))


def flagship_tail_levels(dtype):
    """Shape-only non-factored leg caches of the 4096² tail, chained (the
    plans read shapes, offsets and steps)."""
    dims = FLAGSHIP_TAIL + FLAGSHIP_COARSE[:1]
    levels = []
    for n, nc in zip(dims, dims[1:]):
        c = nf_shape_cache((n, n), 3, 9)
        levels.append(dataclasses.replace(c, A=torch.empty(0, dtype=dtype), col_dims=(nc, nc)))
    return levels


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tail_plan_on_the_flagship_nosym_shapes(dtype):
    """L2 (456²) and L3 (153²) get a down tile (K1's plan: box 63²) and an
    up tile (K2's: box 62²) within the 64 × 64 register box; L4 … L6 run in
    block 0 (0, 0).  ``tail_smem`` covers every tiled leg within a block's
    227 KB; the pass-route cache (tiles (0, 0)) takes none, and a tile other
    than the plan's is refused."""
    levels = flagship_tail_levels(dtype)
    assert [(len(L.offsA), len(L.offsR), len(L.offsP), len(L.steps)) for L in levels] == [(9, 25, 9, 7)] * 5
    tiles = tk.tail_tiles(levels)
    up = tk.tail_up_tiles(levels, tiles)
    assert tiles == ((45, 45), (45, 45)) + ((0, 0),) * 3
    assert up == ((48, 48), (48, 48)) + ((0, 0),) * 3
    for L, t, u in zip(levels[:2], tiles, up):
        assert t == vl.plan_down_nf(L.row_dims, 3, L.offsA, L.offsR, 7)
        assert u == vl.plan_up_nf(L.row_dims, 3, L.offsA, 7)
        assert t[0] + 2 * vl.nf_down_halo(7, 1, vl.nf_spill(L.offsR, 3)) <= vl.REG_BOX
        assert u[0] + 2 * vl.leg_halo(7, 1, False) <= vl.REG_BOX
    smem = tk.tail_smem(levels, tiles, up)
    item = dtype.itemsize
    legs = [vl.nf_tile_smem_bytes(True, t, 7, 1, L.offsR, 3, item) for L, t in zip(levels[:2], tiles)]
    legs += [vl.nf_tile_smem_bytes(False, u, 7, 1, L.offsP, 3, item) for L, u in zip(levels[:2], up)]
    assert smem == max(legs) and smem <= vl.SMEM_LIMIT
    # the down tile's box: x over 63², r over 47², a color byte a cell
    assert smem == (63 * 63 + 47 * 47) * item + 3984
    Mc = torch.zeros((4, 4), dtype=dtype)
    planned = tk.make_fused_tail_cache(levels, Mc)
    assert (planned.tiles, planned.up_tiles, planned.smem) == (tiles, up, smem)
    passed = tk.make_fused_tail_cache(levels, Mc, tiles=((0, 0),) * 5)
    assert passed.up_tiles == ((0, 0),) * 5 and passed.smem == 0
    with pytest.raises(ValueError, match="plan"):
        tk.make_fused_tail_cache(levels, Mc, tiles=((6, 12),) + tiles[1:])


@pytest.fixture(scope="module")
def nosym_ml():
    return amt.structured_smoothed_aggregation(
        amt.poisson((N, N), lattice=True), aggregate=amt.StructuredAggregation(box=3), symmetry=amt.NoSymmetry(),
        **SETUP_KW,
    )


def tail_cache(ml, start):
    cache = tk.build_fused_tail_cache(ml.levels, ml, start, torch.float64, "cpu", max_rows=TAIL_ROWS[start])
    assert cache is not None and not cache.factored
    assert all(L.R.dtype == L.dtype == torch.float64 for L in cache.levels)
    return cache


def tail_by_tiles(cache, tiles, x, b, x_zero, lvl=0):
    """One tail V-cycle with every level's legs run tile by tile and
    stitched: the down leg into x_mid and b_c, the recursion from zero (the
    coarse solve Mc·b_c at the bottom), the up leg from x_mid."""
    L = cache.levels[lvl]
    down, up = tiles[lvl]
    x_mid, bc = run_nf_tiles(L, down, "down", None if x_zero else x, b)
    if lvl == len(cache.levels) - 1:
        xc = cache.Mc @ bc
    else:
        xc = tail_by_tiles(cache, tiles, torch.zeros_like(bc), bc, True, lvl + 1)
    return run_nf_tiles(L, up, "up", x_mid, b, xc)[0]


def leg_tiles(cache, which):
    """Per level (down tile, up tile): the tail's own plan where it tiles
    the level, else (and everywhere with "small") the small tiles."""
    out = []
    for t, u in zip(cache.tiles, cache.up_tiles):
        out.append((t, u) if which == "planned" and t[0] > 0 else SMALL)
    return out


@pytest.mark.parametrize("which", ["planned", "small"])
@pytest.mark.parametrize("start", [0, 1])
def test_tail_vcycle_by_tiles_equals_the_plain_version(nosym_ml, start, which):
    cache = tail_cache(nosym_ml, start)
    dims = [L.row_dims for L in cache.levels]
    assert dims == [(192, 192), (64, 64), (22, 22), (8, 8)][start:]
    planned = [(192, 192) == d for d in dims]
    assert [t[0] > 0 for t in cache.tiles] == [u[0] > 0 for u in cache.up_tiles] == planned
    tiles = leg_tiles(cache, which)
    x, b, _ = stitch_vectors(cache.levels[0], seed=20 + start)
    for x_zero in (False, True):
        xin = torch.zeros_like(x) if x_zero else x
        got = tail_by_tiles(cache, tiles, xin, b, x_zero)
        assert torch.equal(got, tk.fused_tail_reference(cache, xin, b, x_zero=x_zero)), x_zero


@pytest.mark.parametrize("leg", ["down", "up"])
def test_a_tail_halo_short_by_one_cell_shows(nosym_ml, leg, monkeypatch):
    """The stitched tail V-cycle catches an under-sized halo of either leg."""
    cache = tail_cache(nosym_ml, 0)
    x, b, _ = stitch_vectors(cache.levels[0], seed=30)
    if leg == "down":
        real = vl.nf_down_halo
        monkeypatch.setattr(vl, "nf_down_halo", lambda n, r, s: real(n, r, s) - 1)
    else:
        real = vl.leg_halo
        monkeypatch.setattr(vl, "leg_halo", lambda n, r, restriction: real(n, r, restriction) - 1)
    got = tail_by_tiles(cache, leg_tiles(cache, "planned"), x, b, False)
    assert not torch.equal(got, tk.fused_tail_reference(cache, x, b))
