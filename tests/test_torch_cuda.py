"""The port on a CUDA card: the fused-leg, updown, whole-tail,
whole-subcycle, BSG SpMV, natural-order GS, whole-sweep (K5, K7) and slab
stencil (K8) kernels against their plain versions, and one cycle, the
fixed-cycle loop and a refined solve on the card against the CPU, on the
lattice path, on an unstructured (scrambled Poisson) hierarchy, on a 3-D
lattice and on a forward/backward GS lattice; multi-RHS cycles (K6 and
scan_gs per column, K5's masked fallback); the slab SpMV on one slab and on
two gloo ranks sharing the card; K9 with bf16 planes; ``solve_sharded`` on
two gloo ranks sharing the card.

Every test here needs a card and skips without one.  This file imports no
JAX, so on a machine without JAX run it without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -m gpu
"""

import collections

import numpy as np
import pytest
import torch

N = 192
SETUP_KW = dict(proxy=64, cut_rows=2000, min_proxy_dim=16)
TOL = 1e-5

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def ml():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")
    import algebraicmultigrid_tpu_torch as amt

    return amt.structured_smoothed_aggregation(
        amt.poisson((N, N), lattice=True), aggregate=amt.StructuredAggregation(box=3), **SETUP_KW
    )


def _vec(n, pad, seed, dtype=torch.float32):
    v = torch.zeros(pad, dtype=dtype)
    v[:n] = torch.as_tensor(np.random.default_rng(seed).standard_normal(n), dtype=dtype)
    return v.cuda()


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_cuda_legs_match_plain_versions(ml, lvl, dtype):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    h = build_device_hierarchy(ml, device="cuda", dtype=dtype, tail=False)
    L = h.levels[lvl]
    n, pad, nc = L.A.shape[0], L.A.rows_padded, L.R.shape[0]
    x, b, xc = _vec(n, pad, 1, dtype), _vec(n, pad, 2, dtype), _vec(nc, nc, 3, dtype)
    tol = TOL if dtype == torch.float32 else 1e-12
    before = dict(vl.launches)
    for x_zero in (False, True):
        got = vl.fused_down(L.fused, x, b, x_zero=x_zero)
        ref = vl.fused_down_reference(L.fused, x, b, x_zero=x_zero)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert g.shape == r.shape and _rel(g, r) < tol
    got = vl.fused_up(L.fused, x, b, xc)
    assert _rel(got, vl.fused_up_reference(L.fused, x, b, xc)) < tol
    assert vl.launches["down"] == before["down"] + 2
    assert vl.launches["up"] == before["up"] + 1


_SMALL = {}


def _small(n, box, iters=1):
    """The structured-SA hierarchy of poisson((n, n)) with box-k
    aggregation (and ``iters`` multicolor GS sweeps where not 1), set up
    once per module."""
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.config import GaussSeidel

    if (n, box, iters) not in _SMALL:
        gs = {} if iters == 1 else dict(presmoother=GaussSeidel(ordering="multicolor", iter=iters),
                                        postsmoother=GaussSeidel(ordering="multicolor", iter=iters))
        _SMALL[n, box, iters] = amt.structured_smoothed_aggregation(
            amt.poisson((n, n), lattice=True), aggregate=amt.StructuredAggregation(box=box), **gs, **SETUP_KW
        )
    return _SMALL[n, box, iters]


# K3 cases: (hierarchy n, box, level) or (synthetic grid, k, stencil points,
# tile (None: planned)).  200 = 3·66 + 2 and 200 = 2·100 give ragged last
# tiles and, at L1 of the box-2 hierarchy, a 13-point stencil, which K3
# does not take
UPDOWN_CASES = [
    ("h", 192, 3, 0), ("h", 192, 3, 1), ("h", 200, 3, 0), ("h", 200, 3, 1), ("h", 200, 2, 0), ("h", 200, 2, 1),
    ("s", (37, 41), 3, 5, (6, 12)), ("s", (37, 41), 2, 9, None), ("s", (64, 70), 3, 9, (12, 6)),
    ("s", (64, 70), 2, 5, (6, 12)), ("s", (300, 257), 3, 9, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", UPDOWN_CASES, ids=str)
def test_cuda_updown_matches_plain_version(ml, case, dtype):
    """K3 against its plain version on hierarchy levels and on synthetic
    ragged levels (k = 2 and 3, 5- and 9-point, planned and given tiles)."""
    import dataclasses

    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from torch_port_common import synthetic_leg_cache

    if case[0] == "h":
        _, n, box, lvl = case
        f = build_device_hierarchy(_small(n, box), device="cuda", dtype=dtype, tail=False).levels[lvl].fused
    else:
        _, dims, k, n_off, tile = case
        f = synthetic_leg_cache(dims, k, n_off, seed=sum(dims), dtype=dtype, device="cuda")
        if tile is not None:
            f = dataclasses.replace(f, updown_tile=tile)
    Wx, Wy = f.row_dims
    n, nc = Wx * Wy, f.col_dims[0] * f.col_dims[1]
    x, b, xc = _vec(n, n + 3, 1, dtype), _vec(n, n + 3, 2, dtype), _vec(nc, nc, 3, dtype)
    before = vl.launches["updown"]
    if f.updown_tile is None:
        # past the plan: L1 of the box-2 hierarchy (13 points) has no
        # tile; no kernel, no launch
        assert case == ("h", 200, 2, 1)
        with pytest.raises(ValueError):
            vl.fused_updown(f, x, b, xc)
        assert vl.launches["updown"] == before
        return
    tol = TOL if dtype == torch.float32 else 1e-12
    got = vl.fused_updown(f, x, b, xc)
    ref = vl.fused_updown_reference(f, x, b, xc)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _rel(g, r) < tol
    assert vl.launches["updown"] == before + 1


# K1/K2 cases: (synthetic grid, k, stencil points) or (hierarchy n, box,
# level), each under its planned route ("planned": tiled, K2 pipelined on
# 5-point float32 levels), one tile a block ("tiles") and pass by pass
# ("pass").  L1 of the box-2 200² hierarchy (13 points) has no tile.
LEG_CASES = [
    ("s", (37, 41), 3, 5), ("s", (37, 41), 2, 9), ("s", (64, 70), 3, 9), ("s", (64, 70), 2, 5),
    ("s", (300, 257), 3, 5), ("s", (300, 257), 2, 9), ("h", 200, 2, 1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("route", ["planned", "tiles", "pass"])
@pytest.mark.parametrize("case", LEG_CASES, ids=str)
def test_cuda_tiled_legs_match_plain_versions(ml, case, route, dtype):
    """K1 (from x and from zero) and K2 against their plain versions on
    ragged levels (partial last tiles, clipped coarse boxes), k = 2 and 3,
    5- and 9-point, on every route."""
    import dataclasses

    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from torch_port_common import synthetic_leg_cache

    if case[0] == "h":
        _, n, box, lvl = case
        f = build_device_hierarchy(_small(n, box), device="cuda", dtype=dtype, tail=False).levels[lvl].fused
        assert len(f.offsA) == 13 and f.down_tile is None and f.up_tile is None and not f.up_pipelined
    else:
        _, dims, k, n_off = case
        f = synthetic_leg_cache(dims, k, n_off, seed=sum(dims) + 1, dtype=dtype, device="cuda")
        assert f.down_tile is not None and f.up_tile is not None
        # K2's stage fits float64 too at (37, 41)'s small box
        assert f.up_pipelined == (n_off == 5 and (dtype == torch.float32 or dims == (37, 41)))
    if route == "tiles":
        f = dataclasses.replace(f, up_pipelined=False)
    elif route == "pass":
        f = dataclasses.replace(f, down_tile=None, up_tile=None, up_pipelined=False)
    Wx, Wy = f.row_dims
    n, nc = Wx * Wy, f.col_dims[0] * f.col_dims[1]
    x, b, xc = _vec(n, n + 3, 1, dtype), _vec(n, n + 3, 2, dtype), _vec(nc, nc, 3, dtype)
    tol = TOL if dtype == torch.float32 else 1e-12
    before = dict(vl.launches)
    for x_zero in (False, True):
        got = vl.fused_down(f, x, b, x_zero=x_zero)
        ref = vl.fused_down_reference(f, x, b, x_zero=x_zero)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert g.shape == r.shape and _rel(g, r) < tol
    got = vl.fused_up(f, x, b, xc)
    torch.cuda.synchronize()
    assert got.shape == x.shape and _rel(got, vl.fused_up_reference(f, x, b, xc)) < tol
    assert vl.launches["down"] == before["down"] + 2
    assert vl.launches["up"] == before["up"] + 1


def test_cuda_tile_smem_matches_the_plan():
    """The wrappers' tile plans use the kernels' shared-memory formula,
    block-cell limit and descriptor size (under the 1 KB a descriptor that
    test_register_boxes_fit_shared_memory allows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    lib = vl.load_library()
    assert lib.amg_tail_block_cells() == tk.BLOCK_CELLS
    assert lib.amg_tail_level_bytes() <= 1024
    for args in ((48, 48, 7, 1, 4), (45, 45, 9, 1, 8), (34, 34, 62, 2, 4), (6, 12, 0, 1, 8)):
        assert lib.amg_tile_smem_bytes(*args) == vl.tile_smem_bytes(*args)


def test_cuda_fixed_cycles_past_the_updown_plan(ml):
    """A top level past K3's plan (17 symmetric GS sweeps: 69 steps in the
    double sweep) runs K2 then K1 in the fixed-cycle loop, as the CPU does."""
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.config import GaussSeidel
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy, run_fixed_cycles
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    gs = GaussSeidel(ordering="multicolor", iter=17)
    ml17 = amt.structured_smoothed_aggregation(
        amt.poisson((N, N), lattice=True), aggregate=amt.StructuredAggregation(box=3), presmoother=gs,
        postsmoother=gs, **SETUP_KW,
    )
    out, counts, level0 = {}, {}, {}
    for dev in ("cuda", "cpu"):
        # no tail either: its 9-point levels' legs have 103 color steps
        h = build_device_hierarchy(ml17, device=dev, dtype=torch.float64, tail_max_rows=5000)
        assert h.levels[0].fused.updown_tile is None and h.tail is None
        b = _vec(N * N, h.fine_padded, 6, torch.float64).to(dev)
        before = dict(vl.launches)
        vl.level_launches.clear()
        out[dev] = run_fixed_cycles(h, torch.zeros_like(b), b, 3)
        counts[dev] = {k: vl.launches[k] - before[k] for k in before}
        level0[dev] = {name: vl.level_launches[name, (N, N)] for name in ("down", "up", "updown")}
    assert _rel(out["cuda"], out["cpu"]) < 1e-12
    assert level0["cuda"] == {"down": 3, "up": 3, "updown": 0}
    assert counts["cuda"]["updown"] == counts["cuda"]["tail"] == 0
    assert not any(counts["cpu"].values())


# (n, box, GS sweeps) of the tail cases: at 200² the tail's first level
# (67², or 200² itself) is a ragged grid level in tiles; with 5 sweeps (31
# color steps a leg) its box is past the register map and it runs pass by
# pass on the grid
TAIL_START = {(5000, 1): 1, (250_000, 1): 0, (5000, 5): 1}
TAIL_CASES = [((n, 3, 1), rows) for n in (192, 200) for rows in (5000, 250_000)] + [((200, 3, 5), 5000)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("problem,rows", TAIL_CASES, ids=str)
def test_cuda_tail_matches_plain_version(ml, problem, rows, dtype):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.kernels.tail_kernel import BLOCK_CELLS, fused_tail, fused_tail_reference

    n, box, iters = problem
    h = build_device_hierarchy(_small(n, box, iters), device="cuda", dtype=dtype, tail_max_rows=rows)
    assert h.tail is not None and h.tail_start == TAIL_START[rows, iters]
    for L, tile in zip(h.tail.levels, h.tail.tiles):
        assert (tile[0] > 0) == (L.row_dims[0] * L.row_dims[1] > BLOCK_CELLS and iters == 1)
    if iters > 1:
        assert h.tail.levels[0].row_dims == (67, 67) and h.tail.tiles[0] == (0, 0)
    L = h.levels[h.tail_start]
    n, pad = L.A.shape[0], L.A.rows_padded
    x, b = _vec(n, pad, 4, dtype), _vec(n, pad, 5, dtype)
    tol = TOL if dtype == torch.float32 else 1e-12
    before = vl.launches["tail"]
    for x_zero in (False, True):
        got = fused_tail(h.tail, x, b, x_zero=x_zero)
        ref = fused_tail_reference(h.tail, x, b, x_zero=x_zero)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and _rel(got, ref) < tol
    assert vl.launches["tail"] == before + 2


def test_cuda_fixed_cycles_match_cpu(ml):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy, run_fixed_cycles
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    out, counts, routes = {}, {}, {}
    for dev in ("cuda", "cpu"):
        h = build_device_hierarchy(ml, device=dev, dtype=torch.float64, tail_max_rows=5000)
        b = _vec(N * N, h.fine_padded, 6, torch.float64).to(dev)
        before, before_routes = dict(vl.launches), collections.Counter(vl.route_launches)
        out[dev] = run_fixed_cycles(h, torch.zeros_like(b), b, 3)
        counts[dev] = {k: vl.launches[k] - before[k] for k in before}
        routes[dev] = _route_counts(before_routes)
    assert _rel(out["cuda"], out["cpu"]) < 1e-12
    assert counts["cuda"] == {
        "down": 1, "up": 1, "updown": 2, "tail": 3, "sub": 0, "bsg": 0, "scan_gs": 0, "gs": 0, "sweep3d": 0, "halo": 0,
        "down_nf": 0, "up_nf": 0, "tail_nf": 0,
    }
    # float64 planes: K2 and K3 in tiles, one block a tile
    assert routes["cuda"] == collections.Counter({("down", "tiles"): 1, ("up", "tiles"): 1, ("updown", "tiles"): 2})
    assert not any(counts["cpu"].values())


# K9 cases: (n, tail rows, GS sweeps, tail tile edge (None: TAIL_TILE))
SUB_CASES = [(192, 600, 1, None), (600, 5000, 1, None), (600, 5000, 1, 33), (600, 5000, 1, 9), (600, 5000, 5, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", SUB_CASES, ids=str)
def test_cuda_subcycle_matches_plain_version(ml, case, dtype, monkeypatch):
    """K9 at L1 with the tail at L2: of the 192² problem (64², within one
    block), and of the 600² problem (200² = 3·66 + 2: partial tiles and a
    clipped coarse edge, with the tail's 67² a grid level too) in 45-cell
    tiles (the largest register box), 33- and 9-cell tiles (more tiles than
    some grids have blocks), and with 5 GS sweeps pass by pass on the grid
    (its box past the register map)."""
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import subcycle_kernel as sk
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    n, rows, iters, edge = case
    if edge is not None:
        monkeypatch.setattr(tk, "TAIL_TILE", (edge, edge))
    mlp = ml if n == N else _small(n, 3, iters)
    h = build_device_hierarchy(mlp, device="cuda", dtype=dtype, tail_max_rows=rows, subcycle=True)
    assert (h.tail_start, h.sub_start) == (2, 1)
    want = (0, 0) if n == N or iters > 1 else (edge or 45,) * 2
    assert h.sub.tiles[0] == want and h.sub.tiles[1:] == h.tail.tiles
    L = h.levels[1]
    b = _vec(L.A.shape[0], L.A.rows_padded, 7, dtype)
    before = vl.launches["sub"]
    got = sk.fused_subcycle(h.sub, b)
    ref = sk.fused_subcycle_reference(h.sub, b)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == b.shape
    assert _rel(got, ref) < (TOL if dtype == torch.float32 else 1e-12)
    assert vl.launches["sub"] == before + 1


def test_cuda_subcycle_vcycle_launches(ml):
    """One V-cycle with the subcycle: K1 and K2 at L0, K9 for the rest, and
    the same x as on the CPU (float64)."""
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    out, counts = {}, {}
    for dev in ("cuda", "cpu"):
        h = build_device_hierarchy(ml, device=dev, dtype=torch.float64, tail_max_rows=600, subcycle=True)
        b = _vec(N * N, h.fine_padded, 8, torch.float64).to(dev)
        before = dict(vl.launches)
        out[dev] = _one_iteration(h, amt.V(), torch.zeros_like(b), b)
        counts[dev] = {k: vl.launches[k] - before[k] for k in before}
    assert _rel(out["cuda"], out["cpu"]) < 1e-12
    want = dict.fromkeys(counts["cuda"], 0)
    want.update(down=1, up=1, sub=1)
    assert counts["cuda"] == want
    assert not any(counts["cpu"].values())


def test_cuda_subcycle_refuses_a_cache_of_another_device(ml):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels.subcycle_kernel import fused_subcycle

    h = build_device_hierarchy(ml, device="cpu", dtype=torch.float32, tail_max_rows=600, subcycle=True)
    assert h.sub is not None and h.sub.desc is None
    L = h.levels[1]
    with pytest.raises(ValueError):
        fused_subcycle(h.sub, _vec(L.A.shape[0], L.A.rows_padded, 9))


def test_cuda_wrappers_check_their_inputs(ml):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    L = build_device_hierarchy(ml, device="cuda", dtype=torch.float32, tail=False).levels[0]
    n, pad = L.A.shape[0], L.A.rows_padded
    x = _vec(n, pad, 1)
    with pytest.raises(TypeError):
        vl.fused_down(L.fused, x.double(), x.double())
    with pytest.raises(ValueError):
        vl.fused_down(L.fused, x[: n - 1], x)
    with pytest.raises(TypeError):
        vl.fused_updown(L.fused, x.double(), x.double(), x.double())


def test_cuda_cycle_matches_cpu_float64(ml):
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy

    out = {}
    for dev in ("cuda", "cpu"):
        h = build_device_hierarchy(ml, device=dev, dtype=torch.float64)
        b = _vec(N * N, h.fine_padded, 5, torch.float64).to(dev)
        out[dev] = _one_iteration(h, amt.W(), torch.zeros_like(b), b)
    assert _rel(out["cuda"], out["cpu"]) < 1e-12


def test_cuda_solve_refined(ml):
    import algebraicmultigrid_tpu_torch as amt

    b = np.random.default_rng(6).standard_normal(N * N)
    x_gpu, hist_gpu = amt.solve_refined(ml, b, tol=1e-8, device="cuda", log=True)
    x_cpu, hist_cpu = amt.solve_refined(ml, b, tol=1e-8, device="cpu", log=True)
    assert len(hist_gpu) == len(hist_cpu)
    A = ml.levels[0].A
    assert np.linalg.norm(b - A @ x_gpu) / np.linalg.norm(b) < 1e-8


# bf16 coefficient planes (coef_dtype=torch.bfloat16) under float32 and
# float64 vectors (the *_f32_bf16 and *_f64_bf16 entries): K1/K2 cases as
# LEG_CASES, with even-Wy 5-point levels, where K2 pipelines with 2-byte
# planes under either vector type (odd Wy does not), and the 192²
# hierarchy's L0 (5-point, pipelined) and L1 (9-point)
BF16_LEG_CASES = [
    ("s", (37, 41), 3, 5), ("s", (64, 70), 2, 5), ("s", (300, 258), 3, 5), ("s", (300, 257), 2, 9),
    ("s", (64, 70), 3, 9), ("h", 192, 3, 0), ("h", 192, 3, 1), ("h", 200, 2, 1),
]
BF16 = dict(dtype=torch.float32, coef_dtype=torch.bfloat16)
VEC_DTYPES = [torch.float32, torch.float64]


def _tol(dtype):
    return TOL if dtype == torch.float32 else 1e-12


def _bf16_cache(case, seed, dtype=torch.float32):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from torch_port_common import synthetic_leg_cache

    if case[0] == "h":
        _, n, box, lvl = case
        f = build_device_hierarchy(_small(n, box), device="cuda", tail=False, **dict(BF16, dtype=dtype))
        f = f.levels[lvl].fused
    else:
        _, dims, k, n_off = case
        f = synthetic_leg_cache(dims, k, n_off, seed=seed, device="cuda", **dict(BF16, dtype=dtype))
    assert f.A.dtype == f.dinv.dtype == f.T.dtype == f.S.dtype == torch.bfloat16 and f.dtype == dtype
    return f


@pytest.mark.parametrize("dtype", VEC_DTYPES)
@pytest.mark.parametrize("route", ["planned", "tiles", "pass"])
@pytest.mark.parametrize("case", BF16_LEG_CASES, ids=str)
def test_cuda_bf16_legs_match_plain_versions(ml, case, route, dtype):
    """K1 (from x and from zero) and K2 with bf16 planes under float32 and
    float64 vectors against their plain versions on every route: tiled, K2
    pipelined (its stage a pair of coefficients a copy, b and x an element
    a copy) and pass by pass."""
    import dataclasses

    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    f = _bf16_cache(case, seed=sum(case[1]) if case[0] == "s" else 0, dtype=dtype)
    if len(f.offsA) == 13:
        assert f.down_tile is None and f.up_tile is None
    else:
        assert f.up_pipelined == (len(f.offsA) == 5 and f.row_dims[1] % 2 == 0)
    if route == "tiles":
        f = dataclasses.replace(f, up_pipelined=False)
    elif route == "pass":
        f = dataclasses.replace(f, down_tile=None, up_tile=None, up_pipelined=False)
    Wx, Wy = f.row_dims
    n, nc = Wx * Wy, f.col_dims[0] * f.col_dims[1]
    x, b, xc = _vec(n, n + 3, 1, dtype), _vec(n, n + 3, 2, dtype), _vec(nc, nc, 3, dtype)
    before = dict(vl.launches)
    for x_zero in (False, True):
        got = vl.fused_down(f, x, b, x_zero=x_zero)
        ref = vl.fused_down_reference(f, x, b, x_zero=x_zero)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert g.dtype == dtype and g.shape == r.shape and _rel(g, r) < _tol(dtype)
    got = vl.fused_up(f, x, b, xc)
    torch.cuda.synchronize()
    assert got.shape == x.shape and _rel(got, vl.fused_up_reference(f, x, b, xc)) < _tol(dtype)
    assert vl.launches["down"] == before["down"] + 2 and vl.launches["up"] == before["up"] + 1


@pytest.mark.parametrize("dtype", VEC_DTYPES)
@pytest.mark.parametrize("case", [c for c in BF16_LEG_CASES if c != ("h", 200, 2, 1)], ids=str)
def test_cuda_bf16_updown_matches_plain_version(ml, case, dtype):
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    f = _bf16_cache(case, seed=sum(case[1]) + 2 if case[0] == "s" else 0, dtype=dtype)
    assert f.updown_tile is not None
    Wx, Wy = f.row_dims
    n, nc = Wx * Wy, f.col_dims[0] * f.col_dims[1]
    x, b, xc = _vec(n, n + 3, 4, dtype), _vec(n, n + 3, 5, dtype), _vec(nc, nc, 6, dtype)
    before = vl.launches["updown"]
    got = vl.fused_updown(f, x, b, xc)
    ref = vl.fused_updown_reference(f, x, b, xc)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _rel(g, r) < _tol(dtype)
    assert vl.launches["updown"] == before + 1


# The staged K3 (csrc/updown_stage.cuh): 5-point levels with bf16 planes
# under float32 vectors, the 4096² flagship's L0 shape and ragged ones (k = 2
# and 3, the last tiles cut by the grid edge), and the 192² hierarchy's L0
STAGED_CASES = [
    ("s", (4096, 4096), 3), ("s", (200, 200), 3), ("s", (301, 264), 2), ("s", (97, 136), 3), ("s", (64, 72), 2),
    ("h", 192, 3, 0),
]


def _route_counts(before):
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    counts = collections.Counter(vl.route_launches)
    counts.subtract(before)
    return +counts


@pytest.mark.parametrize("case", STAGED_CASES, ids=str)
def test_cuda_updown_staged_matches_register_route(ml, case):
    """The staged K3 against the tiled K3 (one block a tile: bitwise, the
    same terms in the same order from the same values) and against its
    plain version, each route counted by ``route_launches``."""
    import dataclasses

    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from torch_port_common import synthetic_leg_cache

    if case[0] == "h":
        f = _bf16_cache(case, seed=0)
    else:
        f = synthetic_leg_cache(case[1], case[2], 5, seed=sum(case[1]), device="cuda", **BF16)
    assert f.updown_staged and len(f.plane_maps) == 4 * 128
    tiles = dataclasses.replace(f, updown_staged=False)
    Wx, Wy = f.row_dims
    n, nc = Wx * Wy, f.col_dims[0] * f.col_dims[1]
    x, b, xc = _vec(n, n + 8, 7), _vec(n, n + 8, 8), _vec(nc, nc, 9)
    before = collections.Counter(vl.route_launches)
    got = vl.fused_updown(f, x, b, xc)
    ref_k = vl.fused_updown(tiles, x, b, xc)
    torch.cuda.synchronize()
    assert _route_counts(before) == collections.Counter({("updown", "staged"): 1, ("updown", "tiles"): 1})
    ref = vl.fused_updown_reference(f, x, b, xc)
    for g, k, r in zip(got, ref_k, ref):
        assert g.shape == r.shape and torch.equal(g, k) and _rel(g, r) < TOL


# levels the staged K3's plan refuses: float32 planes at the flagship's L0
# shape (the stage does not fit), bf16 rows not a multiple of 16 bytes, 9
# points, float64 vectors
STAGED_REFUSED = [
    ("f32 planes", (4096, 4096), 3, 5, torch.float32, None), ("odd rows", (200, 204), 3, 5, torch.float32, BF16),
    ("9 points", (200, 200), 3, 9, torch.float32, BF16), ("f64 vectors", (200, 200), 3, 5, torch.float64, BF16),
]


@pytest.mark.parametrize("case", STAGED_REFUSED, ids=[c[0] for c in STAGED_REFUSED])
def test_cuda_updown_refused_levels_run_the_tiles(ml, case):
    """A level the staged K3 refuses runs the tiled K3, as the route
    counter shows, and agrees with the plain version."""
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from torch_port_common import synthetic_leg_cache

    _, dims, k, n_off, dtype, bf16 = case
    kw = dict(dtype=dtype) if bf16 is None else dict(bf16, dtype=dtype)
    f = synthetic_leg_cache(dims, k, n_off, seed=sum(dims) + 1, device="cuda", **kw)
    assert f.updown_tile is not None and not f.updown_staged
    Wx, Wy = dims
    n, nc = Wx * Wy, f.col_dims[0] * f.col_dims[1]
    x, b, xc = _vec(n, n + 8, 10, dtype), _vec(n, n + 8, 11, dtype), _vec(nc, nc, 12, dtype)
    before = collections.Counter(vl.route_launches)
    got = vl.fused_updown(f, x, b, xc)
    torch.cuda.synchronize()
    assert _route_counts(before) == collections.Counter({("updown", "tiles"): 1})
    for g, r in zip(got, vl.fused_updown_reference(f, x, b, xc)):
        assert g.shape == r.shape and _rel(g, r) < _tol(dtype)


def test_cuda_updown_stage_smem_matches_the_plan():
    """The staged K3's stage formula is the kernel's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    lib = vl.load_library()
    for box, k, coef in (((62, 62), 3, 2), ((62, 62), 2, 4), ((40, 58), 3, 2), ((9, 12), 2, 2)):
        assert lib.amg_updown_stage_bytes(*box, 1, k, coef, 4) == vl.updown_stage_bytes(box, 1, k, coef, 4)


@pytest.mark.parametrize("dtype", VEC_DTYPES)
@pytest.mark.parametrize("problem,rows", TAIL_CASES, ids=str)
def test_cuda_bf16_tail_matches_plain_version(ml, problem, rows, dtype):
    """K4 with bf16 A, T, S and D⁻¹ at the vectors' dtype (float32 or
    float64) on its tiled grid levels, a grid level pass by pass (5 sweeps)
    and its block-0 levels."""
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.kernels.tail_kernel import fused_tail, fused_tail_reference

    n, box, iters = problem
    h = build_device_hierarchy(_small(n, box, iters), device="cuda", tail_max_rows=rows, **dict(BF16, dtype=dtype))
    assert h.tail is not None and h.tail_start == TAIL_START[rows, iters]
    assert all((L.A.dtype, L.T.dtype, L.S.dtype, L.dinv.dtype) == (torch.bfloat16,) * 3 + (dtype,)
               for L in h.tail.levels)
    L = h.levels[h.tail_start]
    n, pad = L.A.shape[0], L.A.rows_padded
    x, b = _vec(n, pad, 4, dtype), _vec(n, pad, 5, dtype)
    before = vl.launches["tail"]
    for x_zero in (False, True):
        got = fused_tail(h.tail, x, b, x_zero=x_zero)
        ref = fused_tail_reference(h.tail, x, b, x_zero=x_zero)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and _rel(got, ref) < _tol(dtype)
    assert vl.launches["tail"] == before + 2


@pytest.mark.parametrize("dtype", VEC_DTYPES)
def test_cuda_bf16_fixed_cycles_and_solve(ml, dtype):
    """With bf16 planes under float32 or float64 vectors: 3 fixed cycles on
    the card against the CPU's plain versions (the same bf16 values, the
    vectors' arithmetic in another order), with the f32 path's launches;
    the refined solve to 1e-9."""
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy, run_fixed_cycles
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    out, counts, routes = {}, {}, {}
    for dev in ("cuda", "cpu"):
        h = build_device_hierarchy(ml, device=dev, tail_max_rows=5000, **dict(BF16, dtype=dtype))
        b = _vec(N * N, h.fine_padded, 6, dtype).to(dev)
        before, before_routes = dict(vl.launches), collections.Counter(vl.route_launches)
        out[dev] = run_fixed_cycles(h, torch.zeros_like(b), b, 3)
        counts[dev] = {k: vl.launches[k] - before[k] for k in before}
        routes[dev] = _route_counts(before_routes)
    assert out["cuda"].dtype == dtype and _rel(out["cuda"], out["cpu"]) < _tol(dtype)
    assert counts["cuda"] == {
        "down": 1, "up": 1, "updown": 2, "tail": 3, "sub": 0, "bsg": 0, "scan_gs": 0, "gs": 0, "sweep3d": 0, "halo": 0,
        "down_nf": 0, "up_nf": 0, "tail_nf": 0,
    }
    # K3 staged at L0 under float32 vectors, in tiles under float64
    k3 = "staged" if dtype == torch.float32 else "tiles"
    assert routes["cuda"] == collections.Counter({("down", "tiles"): 1, ("up", "pipelined"): 1, ("updown", k3): 2})
    b = np.random.default_rng(6).standard_normal(N * N)
    x, hist = amt.solve_refined(ml, b, tol=1e-10, device="cuda", dtype=dtype, log=True, coef_dtype=torch.bfloat16)
    assert np.linalg.norm(b - ml.levels[0].A @ x) / np.linalg.norm(b) < 1e-9 and len(hist) - 1 <= 4


def test_cuda_bf16_entries_refuse_other_pairs(ml):
    """bf16 planes run under the vectors' dtype the cache was built for,
    with the legs' own dtypes; a pair with no entry raises and launches
    nothing."""
    import dataclasses

    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    lib = vl.load_library()
    for name in ("down", "up", "updown", "tail"):
        for sfx in ("f32_bf16", "f64_bf16"):
            assert getattr(lib, f"amg_fused_{name}_{sfx}") is not None
    f = _bf16_cache(("s", (64, 70), 2, 5), seed=1)
    n = 64 * 70
    x = _vec(n, n, 1)
    before = dict(vl.launches)
    with pytest.raises(TypeError):
        vl.fused_down(f, x.double(), x.double())
    with pytest.raises(TypeError):  # D⁻¹ at float32 beside bf16 planes is the tail's, not a leg's
        vl.fused_down(dataclasses.replace(f, dinv=f.dinv.float()), x, x)
    assert vl.launches == before


@pytest.mark.parametrize("dtype", VEC_DTYPES)
@pytest.mark.parametrize("case", SUB_CASES, ids=str)
def test_cuda_bf16_subcycle_matches_plain_version(ml, case, dtype, monkeypatch):
    """K9's ``f32_bf16`` / ``f64_bf16`` entries (the top level's and the
    tail's A, T, S in bf16, D⁻¹ at the vectors' dtype) against the plain
    version on the cases of the float32/float64 entries."""
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import subcycle_kernel as sk
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    n, rows, iters, edge = case
    if edge is not None:
        monkeypatch.setattr(tk, "TAIL_TILE", (edge, edge))
    mlp = ml if n == N else _small(n, 3, iters)
    h = build_device_hierarchy(mlp, device="cuda", tail_max_rows=rows, subcycle=True, **dict(BF16, dtype=dtype))
    assert (h.tail_start, h.sub_start) == (2, 1)
    assert all((L.A.dtype, L.T.dtype, L.S.dtype, L.dinv.dtype) == (torch.bfloat16,) * 3 + (dtype,)
               for L in h.sub.levels)
    L = h.levels[1]
    b = _vec(L.A.shape[0], L.A.rows_padded, 7, dtype)
    before = vl.launches["sub"]
    got = sk.fused_subcycle(h.sub, b)
    ref = sk.fused_subcycle_reference(h.sub, b)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == b.shape and got.dtype == dtype
    assert _rel(got, ref) < _tol(dtype)
    assert vl.launches["sub"] == before + 1


@pytest.mark.parametrize("dtype", VEC_DTYPES)
def test_cuda_bf16_subcycle_vcycle_matches_cpu(ml, dtype):
    """One V-cycle with the bf16 subcycle on the card against the CPU's
    plain versions: K1 and K2 at L0 and K9 for the rest."""
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    out, counts = {}, {}
    for dev in ("cuda", "cpu"):
        h = build_device_hierarchy(ml, device=dev, tail_max_rows=600, subcycle=True, **dict(BF16, dtype=dtype))
        b = _vec(N * N, h.fine_padded, 8, dtype).to(dev)
        before = dict(vl.launches)
        out[dev] = _one_iteration(h, amt.V(), torch.zeros_like(b), b)
        counts[dev] = {k: vl.launches[k] - before[k] for k in before}
    assert _rel(out["cuda"], out["cpu"]) < _tol(dtype)
    want = dict.fromkeys(counts["cuda"], 0)
    want.update(down=1, up=1, sub=1)
    assert counts["cuda"] == want


@pytest.fixture(scope="module")
def ml_unstructured():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")
    import scipy.sparse as sp

    import algebraicmultigrid_tpu_torch as amt

    A = sp.csr_matrix(amt.poisson((128, 128)))
    p = np.random.default_rng(1).permutation(A.shape[0])
    return amt.smoothed_aggregation(A[p][:, p].tocsr())


def test_cuda_bsg_matches_plain_version(ml_unstructured):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.bsg import BSG
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.kernels.bsg_spmv import bsg_spmv, bsg_spmv_reference

    h = build_device_hierarchy(ml_unstructured, device="cuda", dtype=torch.float32)
    ops = [op for L in h.levels for op in (L.A, L.P, L.R) if isinstance(op, BSG)]
    assert ops and h.perm0 is not None
    before = vl.launches["bsg"]
    for i, B in enumerate(ops):
        x = _vec(B.shape[1], max(B.cols_padded, B.rows_padded), 7 + i)
        got = bsg_spmv(B, x)
        torch.cuda.synchronize()
        assert got.shape == (B.rows_padded,) and _rel(got, bsg_spmv_reference(B, x)) < TOL
    assert vl.launches["bsg"] == before + len(ops)
    with pytest.raises(TypeError):
        bsg_spmv(ops[0], x.double())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_scan_gs_matches_plain_version(ml_unstructured, dtype):
    """Every natural-order level on its planned route and on the streamed
    route."""
    import dataclasses

    from algebraicmultigrid_tpu_torch.models.device import ScanGSCache, build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.kernels.scan_gs import smooth_scan_gs, smooth_scan_gs_reference

    h = build_device_hierarchy(ml_unstructured, device="cuda", dtype=dtype)
    levels = [L for L in h.levels if isinstance(L.pre, ScanGSCache)]
    assert levels
    tol = TOL if dtype == torch.float32 else 1e-12
    before = vl.launches["scan_gs"]
    runs = 0
    for i, L in enumerate(levels):
        c, sp = L.pre, L.pre.split
        splits = [sp, dataclasses.replace(sp, route="streamed")]
        x, b = _vec(L.A.shape[0], L.A.rows_padded, 8 + i, dtype), _vec(L.A.shape[0], L.A.rows_padded, 9 + i, dtype)
        for fwd, bwd in ((True, False), (False, True), (True, True)):
            want = smooth_scan_gs_reference(L.A, c.diag, x, b, c.omega, 2, fwd, bwd)
            for split in splits:
                got = smooth_scan_gs(L.A, dataclasses.replace(c, iter=2, forward=fwd, backward=bwd, split=split), x, b)
                torch.cuda.synchronize()
                assert _rel(got, want) < tol, split.route
                runs += 1
    assert vl.launches["scan_gs"] == before + runs


def test_cuda_scan_gs_smem_matches_the_plan():
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.kernels.scan_gs import smem_bytes

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")
    lib = vl.load_library()
    for rows, w_lo, w_up in ((376, 10, 10), (2048, 13, 14), (24, 0, 5)):
        for itemsize in (4, 8):
            for staged in (False, True):
                assert lib.amg_scan_gs_smem_bytes(rows, w_lo, w_up, itemsize, int(staged)) == smem_bytes(
                    rows, w_lo, w_up, itemsize, staged
                )


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_unstructured_cycle_matches_cpu(ml_unstructured, dtype):
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _enter_basis, _one_iteration, build_device_hierarchy

    out = {}
    for dev in ("cuda", "cpu"):
        h = build_device_hierarchy(ml_unstructured, device=dev, dtype=dtype)
        b = _enter_basis(h, _vec(h.n_fine, h.fine_padded, 10, dtype).to(dev))
        out[dev] = _one_iteration(h, amt.V(), torch.zeros_like(b), b)
    assert _rel(out["cuda"], out["cpu"]) < (TOL if dtype == torch.float32 else 1e-12)


def test_cuda_unstructured_solves(ml_unstructured):
    import algebraicmultigrid_tpu_torch as amt

    A = ml_unstructured.levels[0].A
    b = np.random.default_rng(11).standard_normal(A.shape[0])
    x, it, normr = amt.cg_device(ml_unstructured, b, tol=1e-6, dtype=torch.float32, log=True)
    assert normr <= 1e-6 * np.linalg.norm(b) and np.linalg.norm(b - A @ x) < 1e-4 * np.linalg.norm(b)
    x, hist = amt.solve_refined(ml_unstructured, b, tol=1e-8, log=True)
    assert len(hist) <= 5 and np.linalg.norm(b - A @ x) < 1e-8 * np.linalg.norm(b)


SWEEP_CONFIGS = [(1, True, True, 1.0), (1, True, False, 1.0), (1, False, True, 1.0), (2, True, True, 1.3)]


def _sweep_case(prob, dtype):
    """(level operator, 1/diag, color table, n_colors) of a lattice problem
    on the card."""
    from algebraicmultigrid_tpu_torch.models.lattice import lattice_coloring
    from algebraicmultigrid_tpu_torch.models.lattice_nd import lattice_coloring_nd
    from algebraicmultigrid_tpu_torch.ops.lattice_nd_op import latnd_from_spec
    from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec

    spec = prob.spec
    if len(spec.row_dims) == 3:
        A = latnd_from_spec(spec, dtype, "cuda")
        tab, nc = lattice_coloring_nd(spec)
    else:
        A = lat2d_from_spec(spec, dtype, "cuda", row_pad=8)
        tab, nc = lattice_coloring(spec)
    d = spec.diagonal()
    dinv = torch.zeros(A.rows_padded, dtype=dtype)
    dinv[: d.shape[0]] = torch.as_tensor(1.0 / d, dtype=dtype)
    return A, dinv.cuda(), tab, nc


# (5, 3, 4) is smaller than one tile; (13, 9, 100) and (45, 45, 45) end in
# partial tiles.  Each configuration runs the march as planned, the
# halo-tile kernel (K7's first design, the march's comparison) and the
# march on other boxes and short segments.
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dims", [(5, 3, 4), (13, 9, 100), (45, 45, 45)])
def test_cuda_sweep3d_matches_plain_version(ml, dims, dtype):
    import dataclasses

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.kernels.sweep3d import (
        build_sweep3d_cache, smooth_sweep3d, smooth_sweep3d_reference, smooth_sweep3d_tile,
    )
    from algebraicmultigrid_tpu_torch.ops.kernels.tiled_sweep import plan_march

    lib = vl.load_library()
    A, dinv, tab, nc = _sweep_case(amt.poisson(dims, lattice=True), dtype)
    n = A.shape[0]
    x, b = _vec(n, A.rows_padded, 12, dtype), _vec(n, A.rows_padded, 13, dtype)
    tol = TOL if dtype == torch.float32 else 1e-12
    before = vl.launches["sweep3d"]
    runs = 0
    for it, fwd, bwd, omega in SWEEP_CONFIGS:
        c = build_sweep3d_cache(A, dinv, tab, nc, omega, it, fwd, bwd)
        assert c.march is not None and c.box is None
        S, size = len(c.steps), A.data.element_size()
        assert lib.amg_sweep3d_march_smem_bytes(*c.march.box, S, 1, size) == c.march.smem
        want = smooth_sweep3d_reference(c, x, b)
        got = smooth_sweep3d_tile(c, x, b)
        torch.cuda.synchronize()
        assert got.shape == x.shape and _rel(got, want) < tol, "tile"
        variants = [c]
        for kw in (dict(seg=3), dict(seg=1), dict(box=(16, 16)), dict(box=(24, 48), seg=7)):
            plan, _ = plan_march(c.dims, c.offsets, S, size, **kw)
            variants.append(dataclasses.replace(c, march=plan))
        for v in variants:
            got = smooth_sweep3d(v, x, b)
            torch.cuda.synchronize()
            assert got.shape == x.shape and _rel(got, want) < tol, v.march
        runs += len(variants) + 1
    assert vl.launches["sweep3d"] == before + runs


@pytest.mark.parametrize("dims", [(5, 3, 4), (13, 9, 100), (45, 45, 45)])
def test_cuda_sweep3d_bf16_planes_match_plain_version(ml, dims):
    """K7's march with bf16 planes under float32 vectors
    (``amg_sweep3d_march_f32_bf16``) against its plain version, as planned
    and on other boxes and short segments; the halo-tile kernel refuses bf16
    planes, and a float32 x beside them is the only pair with an entry."""
    import dataclasses

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.lattice_nd import lattice_coloring_nd
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.kernels.sweep3d import (
        build_sweep3d_cache, smooth_sweep3d, smooth_sweep3d_reference, smooth_sweep3d_tile,
    )
    from algebraicmultigrid_tpu_torch.ops.kernels.tiled_sweep import plan_march
    from algebraicmultigrid_tpu_torch.ops.lattice_nd_op import latnd_from_spec

    lib = vl.load_library()
    prob = amt.poisson(dims, lattice=True)
    A = latnd_from_spec(prob.spec, torch.float32, "cuda", coef_dtype=torch.bfloat16)
    assert A.data.dtype == torch.bfloat16 and A.dtype == torch.float32
    tab, nc = lattice_coloring_nd(prob.spec)
    dinv = torch.zeros(A.rows_padded)
    dinv[: A.shape[0]] = torch.as_tensor(1.0 / prob.spec.diagonal())
    dinv = dinv.cuda()
    n = A.shape[0]
    x, b = _vec(n, A.rows_padded, 12), _vec(n, A.rows_padded, 13)
    before = vl.launches["sweep3d"]
    runs = 0
    for it, fwd, bwd, omega in SWEEP_CONFIGS:
        c = build_sweep3d_cache(A, dinv, tab, nc, omega, it, fwd, bwd)
        S = len(c.steps)
        assert c.march is not None and lib.amg_sweep3d_march_smem_bytes(*c.march.box, S, 1, 4) == c.march.smem
        assert c.march == plan_march(c.dims, c.offsets, S, 4, device="cuda", coef_itemsize=2)[0]
        want = smooth_sweep3d_reference(c, x, b)
        variants = [c]
        for kw in (dict(seg=3), dict(seg=1), dict(box=(16, 16)), dict(box=(24, 48), seg=7)):
            plan, _ = plan_march(c.dims, c.offsets, S, 4, coef_itemsize=2, **kw)
            variants.append(dataclasses.replace(c, march=plan))
        for v in variants:
            got = smooth_sweep3d(v, x, b)
            torch.cuda.synchronize()
            assert got.dtype == torch.float32 and got.shape == x.shape and _rel(got, want) < TOL, v.march
        runs += len(variants)
    assert vl.launches["sweep3d"] == before + runs
    with pytest.raises(ValueError, match="halo-tile"):
        smooth_sweep3d_tile(c, x, b)
    with pytest.raises(TypeError):
        smooth_sweep3d(c, x.double(), b.double())
    assert vl.launches["sweep3d"] == before + runs


def test_cuda_3d_bf16_cycle_and_solve(ml_3d):
    """A 3-D hierarchy with bf16 LatND planes under float32: one V-cycle on
    the card against the CPU's (K7's bf16 entry against its plain version,
    2 launches), and the refined solve to 1e-8."""
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    out, counts = {}, {}
    for dev in ("cuda", "cpu"):
        h = build_device_hierarchy(ml_3d, device=dev, **BF16)
        assert h.levels[0].A.data.dtype == torch.bfloat16 and h.levels[0].pre.A is h.levels[0].A
        b = _vec(h.n_fine, h.fine_padded, 16).to(dev)
        before = dict(vl.launches)
        out[dev] = _one_iteration(h, amt.V(), torch.zeros_like(b), b)
        counts[dev] = {k: vl.launches[k] - before[k] for k in before}
    assert _rel(out["cuda"], out["cpu"]) < TOL
    assert counts["cuda"]["sweep3d"] == 2 and not any(counts["cpu"].values())
    A = ml_3d.levels[0].A
    b = np.random.default_rng(17).standard_normal(A.shape[0])
    x, hist = amt.solve_refined(ml_3d, b, tol=1e-8, log=True, coef_dtype=torch.bfloat16)
    assert len(hist) <= 5 and np.linalg.norm(b - A @ x) < 1e-8 * np.linalg.norm(b)


def test_cuda_rs_cycle_matches_cpu(ml):
    """The structured Ruge–Stüben hierarchy (``StructuredRS``, 192² cut to
    six levels): one float64 V-cycle on the card against the CPU, K5 twice
    on every Lat2D level (the 37-offset one through its wide instance) and
    nothing else; the refined solve to 1e-8."""
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.lattice_op import Lat2D

    gs = amt.GaussSeidel(ordering="multicolor")
    ml_rs = amt.ruge_stuben(amt.poisson((N, N), lattice=True), CF=amt.StructuredRS(), presmoother=gs,
                            postsmoother=gs, max_levels=6, **SETUP_KW)
    out, counts = {}, {}
    for dev in ("cuda", "cpu"):
        h = build_device_hierarchy(ml_rs, device=dev, dtype=torch.float64)
        lat = [L for L in h.levels if isinstance(L.A, Lat2D)]
        assert len(lat) == 5 and max(len(L.A.offsets) for L in lat) == 37
        b = _vec(N * N, h.fine_padded, 19, torch.float64).to(dev)
        before = dict(vl.launches)
        out[dev] = _one_iteration(h, amt.V(), torch.zeros_like(b), b)
        counts[dev] = {k: vl.launches[k] - before[k] for k in before}
    assert _rel(out["cuda"], out["cpu"]) < 1e-12
    assert counts["cuda"] == dict(dict.fromkeys(counts["cuda"], 0), gs=2 * len(lat))
    b = np.random.default_rng(20).standard_normal(N * N)
    x, hist = amt.solve_refined(ml_rs, b, tol=1e-8, log=True)
    assert len(hist) <= 5 and np.linalg.norm(b - ml_rs.levels[0].A @ x) < 1e-8 * np.linalg.norm(b)


def _gs_case(grid, dtype):
    """A K5 level "<5pt|9pt>-<Wx>x<Wy>" on the card: (level operator, 1/diag,
    color table, n_colors)."""
    import algebraicmultigrid_tpu_torch as amt

    kind, shape = grid.split("-")
    dims = tuple(int(v) for v in shape.split("x"))
    if kind == "5pt":
        prob = amt.poisson(dims, lattice=True)
    else:
        st = -np.ones((3, 3))
        st[1, 1] = 8.0
        prob = amt.LatticeProblem(st, dims)
    return _sweep_case(prob, dtype)


# (3, 5) is smaller than one strip; the 9-point (131, 77) grid has four
# colors and ends in partial strips and segments; 1366² is L1 and 4096² L0
# of the 4096² flagship.  Each configuration runs the march as planned, the
# halo-tile kernel (K5's first design, the march's comparison) and the
# march on other strips and short segments.
@pytest.mark.parametrize("grid,dtype", [
    (g, d) for g in ("5pt-3x5", "9pt-131x77", "5pt-1366x1366") for d in (torch.float32, torch.float64)
] + [("5pt-4096x4096", torch.float32)])
def test_cuda_gs_sweep_matches_plain_version(ml, grid, dtype):
    import dataclasses

    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.kernels.gs_sweep import (
        build_gs_sweep_cache, smooth_gs, smooth_gs_reference, smooth_gs_tile,
    )
    from algebraicmultigrid_tpu_torch.ops.kernels.tiled_sweep import plan_march

    lib = vl.load_library()
    A, dinv, tab, nc = _gs_case(grid, dtype)
    n = A.shape[0]
    x, b = _vec(n, A.rows_padded, 14, dtype), _vec(n, A.rows_padded, 15, dtype)
    tol = TOL if dtype == torch.float32 else 1e-12
    before = vl.launches["gs"]
    runs = 0
    for it, fwd, bwd, omega in SWEEP_CONFIGS:
        c = build_gs_sweep_cache(A, dinv, tab, nc, omega, it, fwd, bwd)
        S, size = len(c.steps), A.data.element_size()
        assert c.box is None and c.march is not None and c.march.box[0] == 1 and c.dims[1] == 1
        assert lib.amg_gs_sweep_march_smem_bytes(*c.march.box, S, 1, size, len(c.offsets)) == c.march.smem
        assert lib.amg_gs_sweep_march_batch(len(c.offsets)) == c.march.batch
        want = smooth_gs_reference(c, x, b)
        got = smooth_gs_tile(c, x, b)
        torch.cuda.synchronize()
        assert got.shape == x.shape and _rel(got, want) < tol, "tile"
        assert torch.equal(got[n:], x[n:])
        variants = [c]
        for kw in (dict(seg=3), dict(seg=1), dict(box=(1, 2 * S + 9)), dict(box=(1, 64 + 2 * S), seg=7)):
            plan, _ = plan_march(c.dims, c.offsets, S, size, **kw)
            variants.append(dataclasses.replace(c, march=plan))
        for v in variants:
            got = smooth_gs(v, x, b)
            torch.cuda.synchronize()
            assert got.shape == x.shape and _rel(got, want) < tol, v.march
            assert torch.equal(got[n:], x[n:]), "the padding rows pass through"
        runs += len(variants) + 1
    assert vl.launches["gs"] == before + runs
    with pytest.raises(TypeError):
        smooth_gs(c, x.to(torch.float32 if dtype == torch.float64 else torch.float64), b)


def test_cuda_gs_sweep_packed_arguments_survive_reuse(ml):
    """The launch path packs a cache's arguments once: 50 calls on one
    cache, with other caches launched in between (other levels, steps and
    dtypes), equal the first call bitwise and the plain version; x's
    padding passes through on every call."""
    from algebraicmultigrid_tpu_torch.ops.kernels.gs_sweep import build_gs_sweep_cache, smooth_gs, smooth_gs_reference

    caches = []
    for grid, dtype in (("9pt-131x77", torch.float64), ("5pt-96x96", torch.float32), ("5pt-3x5", torch.float64)):
        A, dinv, tab, nc = _gs_case(grid, dtype)
        x, b = _vec(A.shape[0], A.rows_padded, 21, dtype), _vec(A.shape[0], A.rows_padded, 22, dtype)
        x[A.shape[0]:] = 7.0
        for it, fwd, bwd, omega in SWEEP_CONFIGS[1:3]:
            caches.append((build_gs_sweep_cache(A, dinv, tab, nc, omega, it, fwd, bwd), x, b, A.shape[0]))
    first = [smooth_gs(c, x, b) for c, x, b, _ in caches]
    for _ in range(50):
        for (c, x, b, n), want in zip(caches, first):
            got = smooth_gs(c, x, b)
            assert torch.equal(got, want) and bool((got[n:] == 7.0).all())
    torch.cuda.synchronize()
    for (c, x, b, _), got in zip(caches, first):
        tol = TOL if x.dtype == torch.float32 else 1e-12
        assert _rel(got, smooth_gs_reference(c, x, b)) < tol


@pytest.fixture(scope="module")
def ml_3d():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")
    import algebraicmultigrid_tpu_torch as amt

    return amt.structured_smoothed_aggregation_nd(
        amt.poisson((45, 45, 45), lattice=True), proxy=12, cut_rows=2000, min_proxy_dim=9
    )


def test_cuda_3d_cycle_and_solve(ml_3d):
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    out, counts = {}, {}
    for dev in ("cuda", "cpu"):
        h = build_device_hierarchy(ml_3d, device=dev, dtype=torch.float64)
        b = _vec(h.n_fine, h.fine_padded, 16, torch.float64).to(dev)
        before = dict(vl.launches)
        out[dev] = _one_iteration(h, amt.V(), torch.zeros_like(b), b)
        counts[dev] = {k: vl.launches[k] - before[k] for k in before}
    assert _rel(out["cuda"], out["cpu"]) < 1e-12
    assert counts["cuda"]["sweep3d"] == 2 and not any(counts["cpu"].values())
    A = ml_3d.levels[0].A
    b = np.random.default_rng(17).standard_normal(A.shape[0])
    x, hist = amt.solve_refined(ml_3d, b, tol=1e-8, log=True)
    assert len(hist) <= 5 and np.linalg.norm(b - A @ x) < 1e-8 * np.linalg.norm(b)


def test_cuda_fwd_bwd_cycle_runs_k5(ml):
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    ml_fb = amt.structured_smoothed_aggregation(
        amt.poisson((N, N), lattice=True), aggregate=amt.StructuredAggregation(box=3),
        presmoother=amt.GaussSeidel(ordering="multicolor", sweep=amt.ForwardSweep()),
        postsmoother=amt.GaussSeidel(ordering="multicolor", sweep=amt.BackwardSweep()), **SETUP_KW,
    )
    out = {}
    for dev in ("cuda", "cpu"):
        h = build_device_hierarchy(ml_fb, device=dev, dtype=torch.float64)
        b = _vec(N * N, h.fine_padded, 18, torch.float64).to(dev)
        before = vl.launches["gs"]
        out[dev] = _one_iteration(h, amt.V(), torch.zeros_like(b), b)
        assert vl.launches["gs"] - before == (2 * len(h.levels) if dev == "cuda" else 0)
    assert _rel(out["cuda"], out["cpu"]) < 1e-12


def _block(n, pad, seed, dtype):
    X = torch.zeros((pad, 2), dtype=dtype)
    X[:n] = torch.as_tensor(np.random.default_rng(seed).standard_normal((n, 2)), dtype=dtype)
    return X.cuda()


def test_cuda_multi_rhs_unstructured_cycle(ml_unstructured):
    """A block [n, 2] through the unstructured hierarchy on the card: K6 and
    scan_gs run once per column, and each column equals the cycle of that
    column alone."""
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    h = build_device_hierarchy(ml_unstructured, device="cuda", dtype=torch.float32)
    B = _block(h.n_fine, h.fine_padded, 19, torch.float32)
    per = {}
    for j in range(2):
        before = dict(vl.launches)
        col = _one_iteration(h, amt.V(), torch.zeros_like(B[:, j]), B[:, j].contiguous())
        per[j] = ({k: vl.launches[k] - before[k] for k in before}, col)
    before = dict(vl.launches)
    both = _one_iteration(h, amt.V(), torch.zeros_like(B), B)
    torch.cuda.synchronize()
    counts = {k: vl.launches[k] - before[k] for k in before}
    assert counts["bsg"] == 2 * per[0][0]["bsg"] > 0 and counts["scan_gs"] == 2 * per[0][0]["scan_gs"] > 0
    for j in range(2):
        assert _rel(both[:, j], per[j][1]) < TOL


def test_cuda_multi_rhs_k5_level_uses_masked_fallback(ml):
    """A block through a forward/backward GS hierarchy on the card: no K5
    launch (the masked fallback runs it), as in the JAX package, and the
    columns agree with the flat cycles, which do launch K5."""
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    ml_fb = amt.structured_smoothed_aggregation(
        amt.poisson((N, N), lattice=True), aggregate=amt.StructuredAggregation(box=3),
        presmoother=amt.GaussSeidel(ordering="multicolor", sweep=amt.ForwardSweep()),
        postsmoother=amt.GaussSeidel(ordering="multicolor", sweep=amt.BackwardSweep()), **SETUP_KW,
    )
    h = build_device_hierarchy(ml_fb, device="cuda", dtype=torch.float64)
    B = _block(N * N, h.fine_padded, 20, torch.float64)
    before = vl.launches["gs"]
    both = _one_iteration(h, amt.V(), torch.zeros_like(B), B)
    torch.cuda.synchronize()
    assert vl.launches["gs"] == before
    for j in range(2):
        col = _one_iteration(h, amt.V(), torch.zeros_like(B[:, j]), B[:, j].contiguous())
        assert _rel(both[:, j], col) < 1e-12
    assert vl.launches["gs"] == before + 2 * 2 * len(h.levels)


def _cross(reach):
    """A (2·reach + 1)-point cross along each axis: reach 1 is the 5-point
    stencil, reach 2 the 9-point one of a fourth-order Laplacian."""
    offs = [(0, 0)]
    for d in range(1, reach + 1):
        offs += [(d, 0), (-d, 0), (0, d), (0, -d)]
    return tuple(offs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("reach", [1, 2])
@pytest.mark.parametrize("shape", ["thin-77", "odd-131", "wide-256"])
def test_cuda_halo_stencil_matches_plain_version(shape, reach, dtype):
    """K8's two parts against their plain version: a slab of exactly
    2·reach rows (no interior rows: one launch), an odd width and a wide
    one, with a random halo and the planes a row slab of larger planes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.kernels.halo_stencil import halo_stencil, halo_stencil_reference

    kind, wy = shape.split("-")
    Wy = int(wy)
    loc = {"thin": 2 * reach, "odd": 37, "wide": 64}[kind]
    offs = _cross(reach)
    gen = torch.Generator().manual_seed(reach * 1000 + Wy)
    planes = torch.randn((len(offs), loc + 9, Wy), generator=gen, dtype=dtype).cuda()
    data = planes[:, 4 : 4 + loc]  # read in place: a slab of larger planes
    x = torch.randn((loc, Wy), generator=gen, dtype=dtype).cuda()
    halo = torch.randn((2, reach, Wy), generator=gen, dtype=dtype).cuda()
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    before = vl.launches["halo"]
    got = torch.full_like(x, float("nan"))
    halo_stencil(data, x, None, offs, "interior", got)
    halo_stencil(data, x, halo, offs, "boundary", got)
    torch.cuda.synchronize()
    want = torch.empty_like(x)
    halo_stencil_reference(data, x, None, offs, "interior", want)
    halo_stencil_reference(data, x, halo, offs, "boundary", want)
    assert bool(torch.isfinite(got).all()) and _rel(got, want) < tol
    assert vl.launches["halo"] == before + (1 if kind == "thin" else 2)
    with pytest.raises(ValueError):
        halo_stencil(data, x, halo[:, :, :-1].contiguous(), offs, "boundary", got)


def test_cuda_one_slab_halo_spmv_matches_lat2d_spmv(ml):
    """lat2d_spmv_halo with overlap=True on one slab (K8 with zero halos,
    two launches) and with overlap=False against the whole-grid SpMV."""
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec, lat2d_spmv
    from algebraicmultigrid_tpu_torch.parallel import lat2d_spmv_halo, make_row_mesh

    mesh = make_row_mesh(device="cuda")
    for lvl in (0, 1):
        spec = ml.levels[lvl].A.spec
        A = lat2d_from_spec(spec, torch.float32, "cuda", row_pad=8)
        n = A.shape[0]
        x = _vec(n, n, 18)
        want = lat2d_spmv(A, x)[:n]
        before = vl.launches["halo"]
        got = lat2d_spmv_halo(A, x, mesh, overlap=True)
        torch.cuda.synchronize()
        assert vl.launches["halo"] == before + 2
        assert _rel(got, want) < 1e-6
        assert _rel(lat2d_spmv_halo(A, x, mesh), want) < 1e-6


def test_cuda_halo_spmv_on_gloo_ranks_sharing_the_card():
    """Two gloo ranks on one card (edge rows staged through host memory):
    both forms of the slab SpMV against the single-card SpMV."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")
    from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec, lat2d_spmv
    from algebraicmultigrid_tpu_torch.parallel import run_ranks
    from torch_port_common import halo_case, halo_rank

    names = ("p64", "thin")
    res = run_ranks(halo_rank, 2, names, device="cuda", timeout_s=300)
    for name in names:
        spec = halo_case(name, 2)
        Wx, Wy = spec.row_dims
        for dtype in ("float32", "float64"):
            dt = getattr(torch, dtype)
            x = torch.as_tensor(np.random.default_rng(0).standard_normal(Wx * Wy), dtype=dt).cuda()
            want = lat2d_spmv(lat2d_from_spec(spec, dt, "cuda", row_pad=8), x)[: Wx * Wy].cpu().numpy()
            for which in (0, 1):
                got = np.concatenate([r[name, dtype][which] for r in res])
                assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_cuda_solve_sharded_on_gloo_ranks_sharing_the_card():
    """``solve_sharded`` on 2 gloo ranks sharing the card (the rows gathered
    through host memory): the 48² RS problem and the 144² lattice, each
    with the iterations and x of one rank on the card and the same on both
    ranks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")
    from algebraicmultigrid_tpu_torch.parallel import make_row_mesh, run_ranks
    from torch_port_common import DIST_PROBLEMS, dist_rank

    res = run_ranks(dist_rank, 2, device="cuda", timeout_s=300)
    one = dist_rank(make_row_mesh(device="cuda"))
    for name in DIST_PROBLEMS:
        x1, it1, _ = one[name, "solve"]
        for r in res:
            x, it, _ = r[name, "solve"]
            assert it == it1 and np.abs(x - x1).max() <= 1e-10 * np.abs(x1).max(), name
        assert res[0][name, "layout"][0]["A"][0]  # the fine level held in row blocks


# --------------------------------------------------------------------------
# the non-factored R/P-plane entries of K1, K2 and K4 (symmetry=NoSymmetry())
# --------------------------------------------------------------------------

# (vectors, planes) of each entry: f32, f64, f32_bf16, f64_bf16
NF_ENTRIES = {
    "f32": (torch.float32, None), "f64": (torch.float64, None),
    "f32_bf16": (torch.float32, torch.bfloat16), "f64_bf16": (torch.float64, torch.bfloat16),
}


@pytest.fixture(scope="module")
def ml_nosym():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")
    import algebraicmultigrid_tpu_torch as amt

    return amt.structured_smoothed_aggregation(
        amt.poisson((N, N), lattice=True), aggregate=amt.StructuredAggregation(box=3),
        symmetry=amt.NoSymmetry(), **SETUP_KW,
    )


def _nf_tol(dtype):
    return TOL if dtype == torch.float32 else 1e-12


@pytest.mark.parametrize("entry", list(NF_ENTRIES))
@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_cuda_nonfactored_legs_match_plain_versions(ml_nosym, lvl, entry):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    dtype, coef = NF_ENTRIES[entry]
    h = build_device_hierarchy(ml_nosym, device="cuda", dtype=dtype, tail=False, coef_dtype=coef)
    L = h.levels[lvl]
    f = L.fused
    assert not f.factored and vl.plane_suffix(f, "fused_down") == entry
    n, pad, nc = L.A.shape[0], L.A.rows_padded, L.R.shape[0]
    x, b, xc = _vec(n, pad, 1, dtype), _vec(n, pad, 2, dtype), _vec(nc, nc, 3, dtype)
    before = dict(vl.launches)
    for x_zero in (False, True):
        got = vl.fused_down(f, x, b, x_zero=x_zero)
        ref = vl.fused_down_reference(f, x, b, x_zero=x_zero)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert g.shape == r.shape and g.dtype == dtype and _rel(g, r) < _nf_tol(dtype)
    got = vl.fused_up(f, x, b, xc)
    assert _rel(got, vl.fused_up_reference(f, x, b, xc)) < _nf_tol(dtype)
    assert vl.launches["down_nf"] == before["down_nf"] + 2 and vl.launches["up_nf"] == before["up_nf"] + 1
    assert all(vl.launches[k] == before[k] for k in ("down", "up", "updown"))


# the non-factored tiles: the flagship's L0 and L1 shapes (4096², k = 3,
# 5-point, 21 R / 5 P offsets; 1366², 9-point, 25 / 9), the 192²
# NoSymmetry hierarchy's L0 and L2 (22², one partial tile), and ragged
# synthetic levels with partial tiles and clipped coarse boxes
NF_TILE_CASES = [
    ("s", (4096, 4096), 3, 5, "cross"), ("s", (1366, 1366), 3, 9, "box"), ("h", 0), ("h", 2),
    ("s", (37, 41), 3, 5, "cross"), ("s", (64, 70), 2, 9, "box"), ("s", (300, 257), 2, 5, "box"),
]


@pytest.mark.parametrize("entry", list(NF_ENTRIES))
@pytest.mark.parametrize("case", NF_TILE_CASES, ids=str)
def test_cuda_nonfactored_tiles_match_plain_version_and_pass_route(ml_nosym, case, entry):
    """K1's and K2's non-factored entries on a planned tile against their
    plain versions and against the pass route on the same inputs, x_zero
    true and false: one tiled launch a call, the pass route only where the
    tile is taken away."""
    import dataclasses

    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from torch_port_common import synthetic_nf_cache

    dtype, coef = NF_ENTRIES[entry]
    if case[0] == "h":
        h = build_device_hierarchy(ml_nosym, device="cuda", dtype=dtype, tail=False, coef_dtype=coef)
        f = h.levels[case[1]].fused
    else:
        _, dims, k, n_off, p_offsets = case
        f = synthetic_nf_cache(dims, k, n_off, seed=sum(dims) + 5, p_offsets=p_offsets, dtype=dtype, device="cuda",
                               coef_dtype=coef)
    assert not f.factored and vl.plane_suffix(f, "fused_down_nf") == entry
    assert f.down_tile is not None and f.up_tile is not None and f.updown_tile is None
    passed = dataclasses.replace(f, down_tile=None, up_tile=None)
    Wx, Wy = f.row_dims
    n, nc = Wx * Wy, f.col_dims[0] * f.col_dims[1]
    x, b, xc = _vec(n, n + 5, 11, dtype), _vec(n, n + 5, 12, dtype), _vec(nc, nc, 13, dtype)
    tol = _nf_tol(dtype)
    before = collections.Counter(vl.route_launches)
    for x_zero in (False, True):
        got = vl.fused_down(f, x, b, x_zero=x_zero)
        by_pass = vl.fused_down(passed, x, b, x_zero=x_zero)
        ref = vl.fused_down_reference(f, x, b, x_zero=x_zero)
        torch.cuda.synchronize()
        for g, p, r in zip(got, by_pass, ref):
            assert g.shape == r.shape and g.dtype == dtype and _rel(g, r) < tol and _rel(g, p) < tol
    got, by_pass = vl.fused_up(f, x, b, xc), vl.fused_up(passed, x, b, xc)
    torch.cuda.synchronize()
    assert got.shape == x.shape and _rel(got, vl.fused_up_reference(f, x, b, xc)) < tol and _rel(got, by_pass) < tol
    counts = collections.Counter(vl.route_launches)
    counts.subtract(before)
    assert +counts == collections.Counter({("down_nf", "tiles"): 2, ("down_nf", "pass"): 2, ("up_nf", "tiles"): 1,
                                           ("up_nf", "pass"): 1})


def test_cuda_nf_tile_smem_matches_the_plan():
    """The non-factored plans' shared-memory formula is the kernels'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from torch_port_common import nf_offsets

    lib = vl.load_library()
    for k, n_off, p_offsets, tile, steps, itemsize in ((3, 5, "cross", (54, 54), 3, 4), (3, 9, "box", (45, 45), 7, 8),
                                                       (2, 9, "box", (12, 6), 5, 4), (2, 5, "cross", (6, 12), 9, 8)):
        for down, offs in zip((True, False), nf_offsets(k, n_off, p_offsets)):
            flat = vl._ints([v for o in offs for v in o])
            want = vl.nf_tile_smem_bytes(down, tile, steps, 1, offs, k, itemsize)
            assert lib.amg_nf_tile_smem_bytes(int(down), *tile, steps, 1, flat, len(offs), k, itemsize) == want


@pytest.mark.parametrize("entry", list(NF_ENTRIES))
def test_cuda_nonfactored_tail_matches_plain_version(ml_nosym, entry):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    dtype, coef = NF_ENTRIES[entry]
    h = build_device_hierarchy(ml_nosym, device="cuda", dtype=dtype, coef_dtype=coef)
    assert h.tail_start == 0 and not h.tail.factored and h.tail.transfers is not None
    L = h.levels[0]
    n, pad = L.A.shape[0], L.A.rows_padded
    x, b = _vec(n, pad, 4, dtype), _vec(n, pad, 5, dtype)
    before = dict(vl.launches)
    for x_zero in (False, True):
        xin = torch.zeros_like(x) if x_zero else x
        got = tk.fused_tail(h.tail, xin, b, x_zero=x_zero)
        torch.cuda.synchronize()
        assert _rel(got, tk.fused_tail_reference(h.tail, xin, b, x_zero=x_zero)) < _nf_tol(dtype)
    assert vl.launches["tail_nf"] == before["tail_nf"] + 2 and vl.launches["tail"] == before["tail"]


@pytest.fixture(scope="module")
def ml_nosym_1800():
    """The 1800² NoSymmetry problem: its tail from L2 has two 9-point grid
    levels (200², 67²), as the flagship's L2/L3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")
    import algebraicmultigrid_tpu_torch as amt

    return amt.structured_smoothed_aggregation(
        amt.poisson((1800, 1800), lattice=True), aggregate=amt.StructuredAggregation(box=3),
        symmetry=amt.NoSymmetry(),
    )


@pytest.mark.parametrize("entry", list(NF_ENTRIES))
@pytest.mark.parametrize("problem,n_grid", [("ml_nosym", 1), ("ml_nosym_1800", 2)])
def test_cuda_nonfactored_tail_tiles_match_plain_version_and_pass_route(request, problem, n_grid, entry):
    """K4's non-factored entries with every grid level in tiles (the
    plan's down and up tiles) against the plain version and against the
    same levels with the tiles set to (0, 0) (the pass route), from x and
    from zero: one ``tail_nf`` launch a call."""
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    dtype, coef = NF_ENTRIES[entry]
    h = build_device_hierarchy(request.getfixturevalue(problem), device="cuda", dtype=dtype, coef_dtype=coef)
    tail = h.tail
    grid = [L.row_dims[0] * L.row_dims[1] > tk.BLOCK_CELLS for L in tail.levels]
    assert not tail.factored and sum(grid) == n_grid and grid[:n_grid] == [True] * n_grid
    assert [t[0] > 0 for t in tail.tiles] == [u[0] > 0 for u in tail.up_tiles] == grid
    passed = tk.make_fused_tail_cache(tail.levels, tail.Mc, tiles=((0, 0),) * len(tail.levels))
    L = h.levels[h.tail_start]
    n, pad = L.A.shape[0], L.A.rows_padded
    x, b = _vec(n, pad, 14, dtype), _vec(n, pad, 15, dtype)
    tol = _nf_tol(dtype)
    for x_zero in (False, True):
        xin = torch.zeros_like(x) if x_zero else x
        before = dict(vl.launches)
        got = tk.fused_tail(tail, xin, b, x_zero=x_zero)
        assert vl.launches == dict(before, tail_nf=before["tail_nf"] + 1)
        by_pass = tk.fused_tail(passed, xin, b, x_zero=x_zero)
        assert vl.launches == dict(before, tail_nf=before["tail_nf"] + 2)
        ref = tk.fused_tail_reference(tail, xin, b, x_zero=x_zero)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and got.dtype == dtype
        assert _rel(got, ref) < tol and _rel(got, by_pass) < tol and _rel(by_pass, ref) < tol, x_zero


def test_cuda_nonfactored_cycles_match_cpu_and_take_no_updown(ml_nosym):
    """A float64 V-cycle and 3 fixed cycles on the card (non-factored L0
    legs, a non-factored tail from L1) against the CPU: the fixed-cycle
    loop iterates the V-cycle, no K3."""
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy, run_fixed_cycles
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    import algebraicmultigrid_tpu_torch as amt

    out, counts = {}, {}
    for dev in ("cuda", "cpu"):
        h = build_device_hierarchy(ml_nosym, device=dev, dtype=torch.float64, tail_max_rows=5000)
        b = _vec(N * N, h.fine_padded, 6, torch.float64).to(dev)
        before = dict(vl.launches)
        out[dev] = (_one_iteration(h, amt.V(), torch.zeros_like(b), b), run_fixed_cycles(h, torch.zeros_like(b), b, 3))
        counts[dev] = {k: vl.launches[k] - before[k] for k in before}
    for got, want in zip(out["cuda"], out["cpu"]):
        assert _rel(got, want) < 1e-12
    assert counts["cuda"] == dict(dict.fromkeys(counts["cuda"], 0), down_nf=4, up_nf=4, tail_nf=4)
    assert not any(counts["cpu"].values())


def test_cuda_nonfactored_entries_raise_and_never_fall_back(ml_nosym, monkeypatch, tmp_path):
    """An entry the C side refuses (more R offsets than its stencil holds)
    raises and launches nothing; with the library failing to build, the
    non-factored wrappers raise and run no plain version in its place."""
    import dataclasses

    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    h = build_device_hierarchy(ml_nosym, device="cuda", dtype=torch.float32, tail_max_rows=5000)
    f = h.levels[0].fused
    n, pad, nc = h.levels[0].A.shape[0], h.levels[0].A.rows_padded, h.levels[0].R.shape[0]
    x, b, xc = _vec(n, pad, 7), _vec(n, pad, 8), _vec(nc, nc, 9)
    before = dict(vl.launches)
    with pytest.raises(RuntimeError, match="fused_down_nf"):
        vl.fused_down(dataclasses.replace(f, offsR=f.offsR * 2), x, b)
    with pytest.raises(RuntimeError, match="fused_up_nf"):
        vl.fused_up(dataclasses.replace(f, offsP=f.offsP * 8), x, b, xc)
    assert vl.launches == before

    def no_nvcc(*a, **k):
        raise RuntimeError("nvcc failed on ['vcycle_legs.cu']")

    monkeypatch.setattr(vl, "_lib", None)
    monkeypatch.setattr(vl, "library_path", lambda: tmp_path / "missing.so")
    monkeypatch.setattr(vl, "build_library", no_nvcc)
    bt = _vec(nc, h.levels[1].A.rows_padded, 10)
    for call in (lambda: vl.fused_down(f, x, b), lambda: vl.fused_up(f, x, b, xc),
                 lambda: tk.fused_tail(h.tail, bt, bt)):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    assert vl.launches == before
