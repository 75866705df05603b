"""bf16 coefficient planes (``coef_dtype=torch.bfloat16``, the JAX
package's ``AMG_COEF_DTYPE=bfloat16``) on the 192² structured-SA problem:
the port's planes bitwise equal to the JAX package's (the legs' A, D⁻¹, T
and S in bf16; the whole-tail levels' A, T and S in bf16 with D⁻¹ in
float32), the plain versions of K1–K4 against the JAX interpret-mode
kernels on those planes to relative 1e-5 (the bound of
tests/test_torch_vcycle_legs.py), three fixed cycles against three JAX
cycles, the refined solve, the combinations that raise, the paths the
switch leaves at float32, the conversion from numpy, and the plans with
2-byte planes.  Float64 vectors and 3-D lattices with bf16 planes:
tests/test_torch_bf16_f64.py, tests/test_torch_bf16_f64_cycles.py and
tests/test_torch_bf16_3d.py.  The CUDA kernels are held against these
plain versions on the card by tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from torch_port_common import (
    N,
    PLAIN_TILES,
    jax_env,
    jax_hierarchy_to_numpy,
    jax_tail_to_numpy,
    rel_err,
    setup_both,
)

TOL = 1e-5
LEVELS = [0, 1, 2, 3]
BF16 = dict(AMG_COEF_DTYPE="bfloat16")
PLANES = ("A", "dinv", "T", "S")


@pytest.fixture(scope="module")
def problem():
    """The JAX hierarchies with bf16 planes (legs on every level, no tail;
    the whole-tail cache from L0), the port's host hierarchy and its own
    two bf16 device hierarchies of the same shapes."""
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j

    ml_j, ml_t = setup_both()
    with jax_env(**BF16, **PLAIN_TILES):
        h_legs = build_j(ml_j, dtype=jnp.float32)
    with jax_env(**BF16, AMG_PALLAS_TAIL="1"):
        h_tail = build_j(ml_j, dtype=jnp.float32)
    assert h_legs.tail is None and all(L.fused is not None for L in h_legs.levels)
    assert h_tail.tail_start == 0
    return ml_j, ml_t, h_legs, h_tail, _build(ml_t, tail=False), _build(ml_t)


def _build(ml, **kw):
    return amt.build_device_hierarchy(ml, device="cpu", dtype=torch.float32, coef_dtype=torch.bfloat16, **kw)


def _vec(n, pad, seed):
    v = np.zeros(pad, np.float32)
    v[:n] = np.random.default_rng(seed).standard_normal(n)
    return v


def _f32(a):
    """A numpy array (bf16 from the JAX package, or a tensor) as float32."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _numpy_planes(d, names=PLANES):
    """A leg dict with its planes as float32 arrays of bf16 values, the
    form ``hierarchy_from_numpy`` takes."""
    return dict(d, **{k: _f32(d[k]) for k in names})


@pytest.mark.parametrize("lvl", LEVELS)
def test_leg_planes_equal_jax_bitwise(problem, lvl):
    _, _, h_legs, _, own, _ = problem
    from torch_port_common import _fused

    want = _fused(h_legs.levels[lvl].fused)
    f = own.levels[lvl].fused
    assert f.dtype == torch.float32
    for name in PLANES:
        got = getattr(f, name)
        assert got.dtype == torch.bfloat16 and str(np.asarray(want[name]).dtype) == "bfloat16"
        assert np.array_equal(_f32(got), _f32(want[name])), name


def test_tail_planes_equal_jax_bitwise(problem):
    _, _, _, h_tail, _, h = problem
    want = jax_tail_to_numpy(h_tail)
    assert h.tail_start == 0 and len(h.tail.levels) == len(want["levels"])
    assert all(L.fused is None for L in h.levels)
    for L, d in zip(h.tail.levels, want["levels"]):
        assert (L.A.dtype, L.T.dtype, L.S.dtype, L.dinv.dtype) == (torch.bfloat16,) * 3 + (torch.float32,)
        assert str(np.asarray(d["A"]).dtype) == "bfloat16" and np.asarray(d["dinv"]).dtype == np.float32
        for name in PLANES:
            assert np.array_equal(_f32(getattr(L, name)), _f32(d[name])), (L.row_dims, name)
    assert h.tail.Mc.dtype == torch.float32


@pytest.mark.parametrize("x_zero", [False, True])
@pytest.mark.parametrize("lvl", LEVELS)
def test_fused_down_matches_jax_kernel(problem, lvl, x_zero):
    from algebraicmultigrid_tpu.ops.pallas.vcycle_kernels import fused_down as down_j
    from algebraicmultigrid_tpu_torch.ops.kernels.vcycle_legs import fused_down_reference

    _, _, h_j, _, own, _ = problem
    Lj, f = h_j.levels[lvl], own.levels[lvl].fused
    n, pad = Lj.A.shape[0], Lj.A.rows_padded
    x = np.zeros(pad, np.float32) if x_zero else _vec(n, pad, lvl)
    b = _vec(n, pad, 100 + lvl)
    xj, bcj = down_j(Lj.fused, jnp.asarray(x), jnp.asarray(b), x_zero=x_zero)
    xt, bct = fused_down_reference(f, torch.as_tensor(x), torch.as_tensor(b), x_zero=x_zero)
    assert xt.dtype == bct.dtype == torch.float32
    assert rel_err(xt, xj) < TOL and rel_err(bct, bcj) < TOL


@pytest.mark.parametrize("lvl", LEVELS)
def test_fused_up_matches_jax_kernel(problem, lvl):
    from algebraicmultigrid_tpu.ops.pallas.vcycle_kernels import fused_up as up_j
    from algebraicmultigrid_tpu_torch.ops.kernels.vcycle_legs import fused_up_reference

    _, _, h_j, _, own, _ = problem
    Lj, f = h_j.levels[lvl], own.levels[lvl].fused
    n, pad, nc = Lj.A.shape[0], Lj.A.rows_padded, Lj.R.shape[0]
    x, b, xc = _vec(n, pad, 200 + lvl), _vec(n, pad, 300 + lvl), _vec(nc, nc, 400 + lvl)
    xj = up_j(Lj.fused, jnp.asarray(x), jnp.asarray(b), jnp.asarray(xc), out_len=pad)
    xt = fused_up_reference(f, torch.as_tensor(x), torch.as_tensor(b), torch.as_tensor(xc))
    assert xt.dtype == torch.float32 and rel_err(xt, xj) < TOL


def test_fused_updown_matches_jax_kernel(problem):
    from algebraicmultigrid_tpu.ops.pallas.vcycle_kernels import fused_updown as updown_j
    from algebraicmultigrid_tpu_torch.ops.kernels.vcycle_legs import fused_updown_reference

    _, _, h_j, _, own, _ = problem
    Lj, f = h_j.levels[0], own.levels[0].fused
    n, pad, nc = Lj.A.shape[0], Lj.A.rows_padded, Lj.R.shape[0]
    x, b, xc = _vec(n, pad, 3), _vec(n, pad, 4), _vec(nc, nc, 5)
    xj, bcj = updown_j(Lj.fused, jnp.asarray(x), jnp.asarray(b), jnp.asarray(xc))
    xt, bct = fused_updown_reference(f, torch.as_tensor(x), torch.as_tensor(b), torch.as_tensor(xc))
    assert rel_err(xt, np.asarray(xj)[:pad]) < TOL and rel_err(bct, bcj) < TOL


@pytest.mark.parametrize("x_zero", [True, False])
def test_fused_tail_matches_jax_kernel(problem, x_zero):
    """K4's plain version on the port's own bf16 tail and on the JAX tail
    carried across, against the JAX ``fused_tail`` on bf16 planes."""
    from algebraicmultigrid_tpu.ops.pallas.tail_kernel import fused_tail as tail_j
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy
    from algebraicmultigrid_tpu_torch.ops.kernels.tail_kernel import fused_tail_reference

    _, _, _, h_j, _, own = problem
    levels, coarse = jax_hierarchy_to_numpy(h_j)
    tail = jax_tail_to_numpy(h_j)
    tail = dict(tail, levels=[_numpy_planes(d, ("A", "T", "S")) for d in tail["levels"]])
    conv = hierarchy_from_numpy(
        levels, coarse, device="cpu", dtype=torch.float32, tail=tail, tail_start=0, coef_dtype=torch.bfloat16,
    )
    A0 = h_j.levels[0].A
    n, pad = A0.shape[0], A0.rows_padded
    x = np.zeros(pad, np.float32) if x_zero else _vec(n, pad, 1)
    b = _vec(n, pad, 2)
    y_j = np.asarray(tail_j(h_j.tail, jnp.asarray(x), jnp.asarray(b), x_zero=x_zero))
    for h in (conv, own):
        assert all(L.A.dtype == torch.bfloat16 and L.dinv.dtype == torch.float32 for L in h.tail.levels)
        y = fused_tail_reference(h.tail, torch.as_tensor(x), torch.as_tensor(b), x_zero=x_zero)
        assert y.shape == (pad,) and y.dtype == torch.float32
        assert rel_err(y, y_j) < TOL


def test_fixed_cycles_match_iterated_jax_cycles(problem):
    """``run_fixed_cycles`` on the JAX bf16 hierarchy carried across (the
    planes as float32 arrays of bf16 values, rounded on arrival) against
    three JAX V-cycles, in the 2-norm: the two differ by the deduped
    boundary step of the double sweep (tests/test_torch_fixed_cycles.py)."""
    from algebraicmultigrid_tpu.models.device import _one_iteration
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy
    from algebraicmultigrid_tpu_torch.models.device import run_fixed_cycles

    _, _, h_j, _, _, _ = problem
    levels, coarse = jax_hierarchy_to_numpy(h_j)
    levels = [dict(L, fused=_numpy_planes(L["fused"])) for L in levels]
    h_t = hierarchy_from_numpy(levels, coarse, device="cpu", dtype=torch.float32, coef_dtype=torch.bfloat16)
    assert all(L.fused.A.dtype == L.fused.dinv.dtype == torch.bfloat16 for L in h_t.levels)
    b = _vec(N * N, h_j.fine_padded, 3)
    cycle = jax.jit(lambda h, x, b: _one_iteration(h, amg.V(), x, b))
    x_j = jnp.zeros(b.shape[0], jnp.float32)
    for _ in range(3):
        x_j = cycle(h_j, x_j, jnp.asarray(b))
    x_t = run_fixed_cycles(h_t, torch.zeros(b.shape[0]), torch.as_tensor(b), 3)
    x_j = np.asarray(x_j, np.float64)
    assert x_t.shape == x_j.shape
    assert np.linalg.norm(x_t.double().numpy() - x_j) / np.linalg.norm(x_j) < TOL


def test_solve_refined_with_bf16_planes(problem):
    """The refined solve reaches 1e-9 at tol 1e-10, as
    tests/test_fused_legs.py holds the JAX package; its PCG iterations a
    round equal the JAX package's (its inner PCG on the same residuals of
    the f64 outer loop, legs with bf16 planes on every level), give or take
    one."""
    from algebraicmultigrid_tpu.models.device import _pcg_fused

    _, ml_t, h_j, _, _, _ = problem
    b = np.random.default_rng(0).standard_normal(N * N)
    stats = {}
    x, hist = amt.solve_refined(ml_t, b, tol=1e-10, device="cpu", log=True, stats=stats, coef_dtype=torch.bfloat16)
    A = ml_t.levels[0].A
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-9
    assert len(stats["inner_iters"]) == len(hist) - 1 <= 4
    # the JAX inner solves on this f64 loop's residuals
    x64, iters = np.zeros(N * N), []
    for _ in range(len(hist) - 1):
        r = b - A @ x64
        scale = np.linalg.norm(r)
        bp = np.zeros(h_j.fine_padded, np.float32)
        bp[: N * N] = r / scale
        e, it, _ = _pcg_fused(h_j, jnp.asarray(bp), 40, 1e-5, amg.V())
        iters.append(int(it))
        x64 += scale * np.asarray(e, np.float64)[: N * N]
    assert all(abs(a - b) <= 1 for a, b in zip(stats["inner_iters"], iters)), (stats["inner_iters"], iters)


def test_unsupported_combinations_raise(problem):
    """bf16 planes with the subcycle (K9) build the subcycle with bf16
    planes (tests/test_torch_subcycle_bf16.py holds them against the JAX
    package), never float32 planes in their place; a subcycle cache that
    mixes them is refused, and so are planes of another dtype and bf16
    under vectors other than float32/float64.  (Under float64 and on N-D
    lattices bf16 planes are ported: tests/test_torch_bf16_f64.py,
    tests/test_torch_bf16_3d.py.)"""
    from algebraicmultigrid_tpu_torch.ops.kernels.subcycle_kernel import make_fused_subcycle_cache

    _, ml_t, _, _, _, _ = problem
    h = _build(ml_t, tail_max_rows=600, subcycle=True)
    assert h.sub_start == 1 and all(L.A.dtype == torch.bfloat16 for L in h.sub.levels)
    f32 = amt.build_device_hierarchy(ml_t, device="cpu", dtype=torch.float32, tail_max_rows=600, subcycle=True)
    with pytest.raises(ValueError, match="planes"):
        make_fused_subcycle_cache(f32.sub.top, h.sub.tail)
    with pytest.raises(ValueError):
        amt.build_device_hierarchy(ml_t, device="cpu", dtype=torch.float32, coef_dtype=torch.float16)
    with pytest.raises(ValueError):
        amt.build_device_hierarchy(ml_t, device="cpu", dtype=torch.float16, coef_dtype=torch.bfloat16)


def _all_float32(h):
    """Every tensor of a hierarchy's levels, smoothers and coarse cache is
    float32 or an index type."""
    seen = []

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            seen.append(obj.dtype)
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name))
        elif isinstance(obj, (tuple, list)):
            for v in obj:
                walk(v)

    walk(h)
    return bool(seen) and all(d == torch.float32 or not d.is_floating_point for d in seen)


def test_paths_without_planes_keep_float32(problem):
    """The switch changes only the legs' and the tail's planes: a
    forward/backward GS lattice hierarchy (K5, no legs, no tail) and an
    unstructured one build float32 caches under it, and the legs'
    hierarchy keeps its own operators and smoothers at float32."""
    from torch_port_common import scrambled_poisson

    _, _, _, _, own, _ = problem
    fb = amt.structured_smoothed_aggregation(
        amt.poisson((N, N), lattice=True), aggregate=amt.StructuredAggregation(box=3),
        presmoother=amt.GaussSeidel(ordering="multicolor"),
        postsmoother=amt.GaussSeidel(amt.BackwardSweep(), ordering="multicolor"),
        proxy=64, cut_rows=2000, min_proxy_dim=16,
    )
    for ml in (fb, amt.smoothed_aggregation(scrambled_poisson(32))):
        h = _build(ml)
        assert h.tail is None and all(L.fused is None for L in h.levels)
        assert _all_float32(h)
    for L in own.levels:
        assert _all_float32(dataclasses.replace(L, fused=None))
        assert L.fused.A.dtype == torch.bfloat16


def test_convert_round_trip_with_bf16_planes(problem):
    """The port's own bf16 hierarchy read out as float32 arrays and
    carried back with ``coef_dtype``: the same planes, bitwise, and the
    same plans."""
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy

    _, _, h_j, _, own, _ = problem
    levels, coarse = jax_hierarchy_to_numpy(h_j)

    def as_dict(f):
        d = {k: getattr(f, k) for k in ("offsA", "color_grid", "n_colors", "k", "row_dims", "col_dims", "omega",
                                        "iter", "forward", "backward")}
        return dict(d, **{k: _f32(getattr(f, k)) for k in PLANES})

    levels = [dict(L, fused=as_dict(T.fused)) for L, T in zip(levels, own.levels)]
    back = hierarchy_from_numpy(levels, coarse, device="cpu", dtype=torch.float32, coef_dtype="bfloat16")
    for L, T in zip(back.levels, own.levels):
        for name in PLANES:
            assert torch.equal(getattr(L.fused, name), getattr(T.fused, name))
        assert (L.fused.down_tile, L.fused.up_tile, L.fused.up_pipelined) == (
            T.fused.down_tile, T.fused.up_tile, T.fused.up_pipelined)


def test_cpu_wrappers_take_the_plain_version_with_bf16_planes(problem):
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.kernels.tail_kernel import fused_tail, fused_tail_reference

    _, _, _, _, own, own_tail = problem
    f = own.levels[0].fused
    n, nc = N * N, f.col_dims[0] * f.col_dims[1]
    x, b, xc = (torch.as_tensor(_vec(m, m, s)) for m, s in ((n, 1), (n, 2), (nc, 3)))
    before = dict(vl.launches)
    assert all(torch.equal(g, r) for g, r in zip(vl.fused_down(f, x, b), vl.fused_down_reference(f, x, b)))
    assert torch.equal(vl.fused_up(f, x, b, xc), vl.fused_up_reference(f, x, b, xc))
    assert all(torch.equal(g, r) for g, r in zip(vl.fused_updown(f, x, b, xc), vl.fused_updown_reference(f, x, b, xc)))
    tail = own_tail.tail
    assert torch.equal(fused_tail(tail, x, b), fused_tail_reference(tail, x, b))
    assert vl.launches == before
    assert vl.plane_suffix(f, "fused_down") == "f32_bf16"
    assert vl.plane_suffix(tail.levels[0], "fused_tail", dinv_working=True) == "f32_bf16"
    with pytest.raises(TypeError):
        vl.plane_suffix(tail.levels[0], "fused_down")  # D⁻¹ at float32 has no leg entry


def _shape_cache(dims, k, n_off, coef=torch.bfloat16):
    """A leg cache with the plans of a ``dims`` level under float32 vectors
    and ``coef`` planes, and no plane data (the plans read shapes, the
    stencil, the steps and the itemsizes)."""
    from torch_port_common import LEG_COLORS, LEG_OFFSETS

    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    grid = LEG_COLORS[n_off]
    empty = torch.empty(0, dtype=coef)
    return vl.with_tile_plans(vl.FusedLegCache(
        A=empty, dinv=empty, T=empty, S=empty, offsA=LEG_OFFSETS[n_off], color_grid=grid,
        n_colors=len({c for row in grid for c in row}), k=k, row_dims=dims,
        col_dims=(-(-dims[0] // k), -(-dims[1] // k)), omega=1.0, iter=1, forward=True, backward=True,
    ))


def test_plans_at_4096_with_bf16_planes():
    """The tile plans at 4096² are the float32 ones (the tile buffers hold
    float32 vectors only): L0 54² with K2 pipelined, L1 45² down and 48² up,
    the tail's 456² and 153² in 45² tiles.  K2's stage counts 2-byte planes
    and 4-byte vectors each at its own size, with even rows; a level of odd
    Wy does not pipeline with 2-byte planes."""
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    L0 = _shape_cache((4096, 4096), 3, 5)
    assert L0.dtype == torch.float32
    assert (L0.down_tile, L0.up_tile, L0.up_pipelined, L0.updown_tile) == ((54, 54), (54, 54), True, (48, 48))
    L1 = _shape_cache((1366, 1366), 3, 9)
    assert (L1.down_tile, L1.up_tile, L1.up_pipelined) == ((45, 45), (48, 48), False)
    tail = [_shape_cache((n, n), 3, 9) for n in (456, 153, 51, 17)]
    assert tk.tail_tiles(tail) == ((45, 45), (45, 45), (0, 0), (0, 0))
    assert tk.tail_smem(tail, tk.tail_tiles(tail)) == vl.tile_smem_bytes(45, 45, 9, 1, 4)
    # b, x (60 × 62) and x_c (22²) at 4 bytes; A, dinv, S (60 × 62) and T (62 × 64) at 2
    stage = (2 * 60 * 62 + 22 * 22) * 4 + (7 * 60 * 62 + 62 * 64) * 2
    assert vl.stage_bytes((60, 60), 5, 1, 3, 4, 2) == -(-stage // 16) * 16
    assert vl.stage_bytes((60, 60), 5, 1, 3, 4, 4) == vl.stage_bytes((60, 60), 5, 1, 3, 4)
    assert not _shape_cache((4096, 4095), 3, 5).up_pipelined
    assert _shape_cache((4096, 4095), 3, 5, torch.float32).up_pipelined


def _stage_rows(plane, i0, j0, rows, cols):
    """The pipelined K2's 2-byte staging of a plane's box rows (i0.., j0..)
    as csrc/vcycle_legs.cu ``stage_tile`` copies it: rows of an even
    length from the even column j0 − s, a pair a copy, pairs outside the
    grid zero; returns (stage, row length, s)."""
    Wx, Wy = plane.shape
    s = j0 & 1
    width = (cols + 2) & ~1
    out = np.zeros((rows, width), plane.dtype)
    for r in range(rows):
        for p in range(width // 2):
            i, j = i0 + r, j0 - s + 2 * p
            if 0 <= i < Wx and 0 <= j < Wy:
                out[r, 2 * p : 2 * p + 2] = plane[i, j : j + 2]
    return out, width, s


@pytest.mark.parametrize("tile", [(54, 54), (20, 34), (9, 12)])
def test_pair_staging_reads_every_cell(tile):
    """On a grid of even Wy every pair of the 2-byte stage lies inside the
    grid or outside it whole, and the staged index e0·E1s + s + e1 (and
    u0·U1s + su + u1 for T's area) reads each box cell's coefficient, for
    boxes at every offset parity and clipped at each edge."""
    Wx, Wy, h, r = 121, 130, 3, 1
    plane = np.arange(Wx * Wy, dtype=np.float64).reshape(Wx, Wy) + 1
    for ti in range(-(-Wx // tile[0])):
        for tj in range(-(-Wy // tile[1])):
            ox, oy = ti * tile[0] - h, tj * tile[1] - h
            E0, E1 = tile[0] + 2 * h, tile[1] + 2 * h
            for (i0, j0, rows, cols) in ((ox, oy, E0, E1), (ox - r, oy - r, E0 + 2 * r, E1 + 2 * r)):
                st, width, s = _stage_rows(plane, i0, j0, rows, cols)
                assert width % 2 == 0 and width >= cols + s
                for e0 in range(rows):
                    for e1 in range(cols):
                        i, j = i0 + e0, j0 + e1
                        if 0 <= i < Wx and 0 <= j < Wy:
                            assert st.reshape(-1)[e0 * width + s + e1] == plane[i, j]
