"""bf16 coefficient planes under float64 vectors and on 3-D lattices
(``coef_dtype=torch.bfloat16``; the JAX package's ``AMG_COEF_DTYPE=bfloat16``
with x64, and on LatND levels under float32), held against the JAX package:

* on the 192² structured-SA problem in float64, the legs' A, D⁻¹, T and S
  (rounded from float32) and the whole-tail levels' A, T and S (rounded from
  float64; D⁻¹ and Mc float64) bitwise equal to the JAX package's; the plain
  K1–K4 on those planes against the JAX interpret-mode kernels to 1e-10
  relative; three fixed cycles against three JAX cycles to 1e-10; the
  refined solve;
* on 3-D lattices, LatND planes in bf16 bitwise equal to the JAX
  package's under float32 and kept at float64 under float64; the LatND
  SpMV with bf16 planes to 1e-6; K7's plain version on bf16 planes against
  the JAX K7 in interpret mode to 1e-5; ``cg_device`` with the iterations
  of the JAX package's; the JAX hierarchy's bf16 LatND planes carried
  across by ``convert.hierarchy_from_numpy``;
* K9 building its subcycle on bf16 planes under float32 and float64.

The CUDA entries ``*_f64_bf16`` and ``amg_sweep3d_march_f32_bf16`` are held
against these plain versions on the card by tests/test_torch_cuda.py."""

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
    _fused,
    jax_env,
    jax_hierarchy_to_numpy,
    jax_tail_to_numpy,
    rel_err,
    setup_both,
)

TOL = 1e-10
LEVELS = [0, 1, 2, 3]
BF16 = dict(AMG_COEF_DTYPE="bfloat16")
PLANES = ("A", "dinv", "T", "S")
F64 = torch.float64
# a small 3-D problem whose L0 is a LatND level (tests/test_torch_lattice_nd.py's
# setup at 32³)
DIMS3 = (32, 32, 32)
KW3 = dict(proxy=12, cut_rows=2000, min_proxy_dim=9)


@pytest.fixture(scope="module")
def problem():
    """The JAX float64 hierarchies with bf16 planes (legs on every level; the
    whole-tail cache from L0) and the port's own of the same shapes."""
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j

    ml_j, ml_t = setup_both()
    with jax_env(**BF16, **PLAIN_TILES):
        h_legs = build_j(ml_j, dtype=jnp.float64)
    with jax_env(**BF16, AMG_PALLAS_TAIL="1"):
        h_tail = build_j(ml_j, dtype=jnp.float64)
    assert h_legs.tail is None and all(L.fused is not None for L in h_legs.levels)
    assert h_tail.tail_start == 0
    return ml_j, ml_t, h_legs, h_tail, _build(ml_t, tail=False), _build(ml_t)


def _build(ml, dtype=F64, **kw):
    return amt.build_device_hierarchy(ml, device="cpu", dtype=dtype, coef_dtype=torch.bfloat16, **kw)


def _vec(n, pad, seed, dtype=np.float64):
    v = np.zeros(pad, dtype)
    v[:n] = np.random.default_rng(seed).standard_normal(n)
    return v


def _as(a, dtype=np.float64):
    """A numpy array (bf16 from the JAX package) or a tensor as ``dtype``."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy().astype(dtype)
    return np.asarray(a).astype(dtype)


@pytest.mark.parametrize("lvl", LEVELS)
def test_leg_planes_equal_jax_bitwise(problem, lvl):
    """The legs' planes under float64: computed at float32 and rounded, as
    the JAX leg builder does under either working dtype."""
    _, _, h_legs, _, own, _ = problem
    want = _fused(h_legs.levels[lvl].fused)
    f = own.levels[lvl].fused
    assert f.dtype == F64
    for name in PLANES:
        got = getattr(f, name)
        assert got.dtype == torch.bfloat16 and str(np.asarray(want[name]).dtype) == "bfloat16"
        assert np.array_equal(_as(got), _as(want[name])), name


def test_tail_planes_equal_jax_bitwise(problem):
    """The whole-tail levels' A, T and S rounded from float64, D⁻¹ and Mc at
    float64."""
    _, _, _, h_tail, _, h = problem
    want = jax_tail_to_numpy(h_tail)
    assert h.tail_start == 0 and len(h.tail.levels) == len(want["levels"])
    for L, d in zip(h.tail.levels, want["levels"]):
        assert (L.A.dtype, L.T.dtype, L.S.dtype, L.dinv.dtype, L.dtype) == (torch.bfloat16,) * 3 + (F64, F64)
        assert np.asarray(d["dinv"]).dtype == np.float64
        for name in PLANES:
            assert np.array_equal(_as(getattr(L, name)), _as(d[name])), (L.row_dims, name)
    assert h.tail.Mc.dtype == F64


def test_vectors_and_operators_stay_float64(problem):
    """Every level's own operator, the smoother caches' D⁻¹ and the
    refined solve's fine operator stay float64; the plans of the legs are
    float64's, the pipelined K2 where 2-byte planes make its stage fit."""
    from algebraicmultigrid_tpu_torch.models.device import _get_fine_f64
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    _, ml_t, _, _, own, _ = problem
    h64 = amt.build_device_hierarchy(ml_t, device="cpu", dtype=F64, tail=False)
    for L, L64 in zip(own.levels, h64.levels):
        assert all(getattr(L, op).data.dtype == F64 for op in ("A", "P", "R"))
        assert L.pre.dinv.dtype == F64
        f, g = L.fused, L64.fused
        assert (f.down_tile, f.up_tile, f.updown_tile) == (g.down_tile, g.up_tile, g.updown_tile)
        assert vl.plane_suffix(f, "fused_down") == "f64_bf16"
    assert own.levels[0].fused.up_pipelined and not h64.levels[0].fused.up_pipelined
    assert _get_fine_f64(ml_t, "cpu").dtype == F64


@pytest.mark.parametrize("x_zero", [False, True])
@pytest.mark.parametrize("lvl", LEVELS)
def test_fused_down_matches_jax_kernel(problem, lvl, x_zero):
    from algebraicmultigrid_tpu.ops.pallas.vcycle_kernels import fused_down as down_j
    from algebraicmultigrid_tpu_torch.ops.kernels.vcycle_legs import fused_down_reference

    _, _, h_j, _, own, _ = problem
    Lj, f = h_j.levels[lvl], own.levels[lvl].fused
    n, pad = Lj.A.shape[0], Lj.A.rows_padded
    x = np.zeros(pad) if x_zero else _vec(n, pad, lvl)
    b = _vec(n, pad, 100 + lvl)
    xj, bcj = down_j(Lj.fused, jnp.asarray(x), jnp.asarray(b), x_zero=x_zero)
    xt, bct = fused_down_reference(f, torch.as_tensor(x), torch.as_tensor(b), x_zero=x_zero)
    assert xt.dtype == bct.dtype == F64 and np.asarray(xj).dtype == np.float64
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
    assert xt.dtype == F64 and rel_err(xt, xj) < TOL


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
    """K4's plain version on the port's own float64 tail with bf16 planes
    and on the JAX tail carried across, against the JAX ``fused_tail``."""
    from algebraicmultigrid_tpu.ops.pallas.tail_kernel import fused_tail as tail_j
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy
    from algebraicmultigrid_tpu_torch.ops.kernels.tail_kernel import fused_tail_reference

    _, _, _, h_j, _, own = problem
    levels, coarse = jax_hierarchy_to_numpy(h_j)
    tail = jax_tail_to_numpy(h_j)
    tail = dict(tail, levels=[dict(d, **{k: _as(d[k], np.float32) for k in ("A", "T", "S")}) for d in tail["levels"]])
    conv = hierarchy_from_numpy(levels, coarse, device="cpu", dtype=F64, tail=tail, tail_start=0,
                                coef_dtype=torch.bfloat16)
    A0 = h_j.levels[0].A
    n, pad = A0.shape[0], A0.rows_padded
    x = np.zeros(pad) if x_zero else _vec(n, pad, 1)
    b = _vec(n, pad, 2)
    y_j = np.asarray(tail_j(h_j.tail, jnp.asarray(x), jnp.asarray(b), x_zero=x_zero))
    for h in (conv, own):
        assert all(L.A.dtype == torch.bfloat16 and L.dinv.dtype == F64 for L in h.tail.levels)
        y = fused_tail_reference(h.tail, torch.as_tensor(x), torch.as_tensor(b), x_zero=x_zero)
        assert y.shape == (pad,) and y.dtype == F64
        assert rel_err(y, y_j) < TOL


def test_fixed_cycles_match_iterated_jax_cycles(problem):
    """``run_fixed_cycles`` in float64 on the JAX hierarchy carried across
    (planes as float32 arrays of bf16 values) against three JAX V-cycles."""
    from algebraicmultigrid_tpu.models.device import _one_iteration
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy
    from algebraicmultigrid_tpu_torch.models.device import run_fixed_cycles

    _, _, h_j, _, _, _ = problem
    levels, coarse = jax_hierarchy_to_numpy(h_j)
    levels = [dict(L, fused=dict(L["fused"], **{k: _as(L["fused"][k], np.float32) for k in PLANES}))
              for L in levels]
    h_t = hierarchy_from_numpy(levels, coarse, device="cpu", dtype=F64, coef_dtype=torch.bfloat16)
    assert all(L.fused.A.dtype == torch.bfloat16 and L.fused.dtype == F64 for L in h_t.levels)
    b = _vec(N * N, h_j.fine_padded, 3)
    cycle = jax.jit(lambda h, x, b: _one_iteration(h, amg.V(), x, b))
    x_j = jnp.zeros(b.shape[0], jnp.float64)
    for _ in range(3):
        x_j = cycle(h_j, x_j, jnp.asarray(b))
    x_t = run_fixed_cycles(h_t, torch.zeros(b.shape[0], dtype=F64), torch.as_tensor(b), 3)
    assert x_t.dtype == F64 and rel_err(x_t, x_j) < TOL


def test_solve_refined_in_float64_with_bf16_planes(problem):
    """The refined solve with float64 inner solves on bf16 planes reaches
    1e-10 within 4 rounds, each round's PCG iterations those of the JAX
    inner solve (``_pcg_fused``, float64, the legs on bf16 planes) on the
    same residuals, give or take one."""
    from algebraicmultigrid_tpu.models.device import _pcg_fused

    _, ml_t, h_j, _, _, _ = problem
    b = np.random.default_rng(0).standard_normal(N * N)
    stats = {}
    x, hist = amt.solve_refined(ml_t, b, tol=1e-10, device="cpu", dtype="float64", log=True, stats=stats,
                                coef_dtype="bfloat16")
    A = ml_t.levels[0].A
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-10
    assert len(stats["inner_iters"]) == len(hist) - 1 <= 4
    x64, iters = np.zeros(N * N), []
    for _ in range(len(hist) - 1):
        r = b - A @ x64
        scale = np.linalg.norm(r)
        bp = np.zeros(h_j.fine_padded)
        bp[: N * N] = r / scale
        e, it, _ = _pcg_fused(h_j, jnp.asarray(bp), 40, 1e-5, amg.V())
        iters.append(int(it))
        x64 += scale * np.asarray(e, np.float64)[: N * N]
    assert all(abs(a - b) <= 1 for a, b in zip(stats["inner_iters"], iters)), (stats["inner_iters"], iters)


# --------------------------------------------------------------------------
# 3-D lattices
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def problem3():
    """The 32³ problem set up by both packages (fresh JAX objects: the JAX
    engine caches its device hierarchy on ``ml``)."""
    ml_j = amg.structured_smoothed_aggregation_nd(amg.poisson(DIMS3, lattice=True), **KW3)
    ml_t = amt.structured_smoothed_aggregation_nd(amt.poisson(DIMS3, lattice=True), **KW3)
    assert isinstance(ml_t.levels[0].A, amt.LatticeMatrixND)
    return ml_j, ml_t


@pytest.mark.parametrize("op", ["A", "P", "R"])
def test_latnd_planes_equal_jax_bitwise(problem3, op):
    """Under float32 the JAX package stores a LatND's planes in bf16,
    expanded at float32 and rounded; under float64 it keeps them at
    float64.  So does the port, through ``build_device_hierarchy``."""
    from algebraicmultigrid_tpu.ops.lattice_nd_op import latnd_from_spec as from_j

    ml_j, ml_t = problem3
    spec = getattr(ml_j.levels[0], op).spec
    h32, h64 = _build(ml_t, torch.float32), _build(ml_t)
    with jax_env(**BF16):
        want32, want64 = from_j(spec, dtype=jnp.float32), from_j(spec, dtype=jnp.float64)
    got32, got64 = getattr(h32.levels[0], op), getattr(h64.levels[0], op)
    assert str(want32.data.dtype) == "bfloat16" and got32.data.dtype == torch.bfloat16
    assert got32.dtype == torch.float32 and got32.rows_padded == want32.rows_padded
    assert np.array_equal(_as(got32.data), _as(want32.data))
    assert want64.data.dtype == jnp.float64 and got64.data.dtype == got64.dtype == F64
    assert np.array_equal(got64.data.numpy(), np.asarray(want64.data))


@pytest.mark.parametrize("op", ["A", "P", "R"])
def test_latnd_spmv_with_bf16_planes_matches_jax(problem3, op):
    """The bf16 planes multiply as float32 values in float32 arithmetic."""
    from algebraicmultigrid_tpu.ops.lattice_nd_op import latnd_from_spec as from_j, latnd_spmv as spmv_j
    from algebraicmultigrid_tpu_torch.ops.banded import mat_vec
    from algebraicmultigrid_tpu_torch.ops.lattice_nd_op import latnd_from_spec as from_t

    ml_j, ml_t = problem3
    with jax_env(**BF16):
        Mj = from_j(getattr(ml_j.levels[0], op).spec, dtype=jnp.float32)
    Mt = from_t(getattr(ml_t.levels[0], op).spec, torch.float32, "cpu", coef_dtype=torch.bfloat16)
    x = np.random.default_rng(0).standard_normal(Mt.shape[1] + 3).astype(np.float32)
    want = np.asarray(spmv_j(Mj, jnp.asarray(x)))
    got = mat_vec(Mt, torch.as_tensor(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.shape == want.shape and rel_err(got.numpy(), want) < 1e-6


@pytest.mark.parametrize("fwd,bwd", [(True, True), (True, False)])
def test_k7_plain_with_bf16_planes_matches_jax_kernel(fwd, bwd):
    """On (13, 9, 128), in interpret mode (``AMG_SWEEP3D=1``'s cache with
    bf16 planes, D⁻¹ float32); the port's K7 reads the level's own bf16
    planes in place and plans its march with 4-byte vectors."""
    from algebraicmultigrid_tpu.models.device import _build_smoother_cache
    from algebraicmultigrid_tpu.ops.lattice_nd_op import latnd_from_spec as from_j
    from algebraicmultigrid_tpu.ops.pallas.sweep3d_kernel import Sweep3DCache, build_sweep3d_cache as build_j
    from algebraicmultigrid_tpu.ops.pallas.sweep3d_kernel import smooth_sweep3d as smooth_j
    from algebraicmultigrid_tpu_torch.models.lattice_nd import lattice_coloring_nd
    from algebraicmultigrid_tpu_torch.ops.kernels.sweep3d import build_sweep3d_cache, smooth_sweep3d
    from algebraicmultigrid_tpu_torch.ops.kernels.tiled_sweep import plan_march, tile_view
    from algebraicmultigrid_tpu_torch.ops.lattice_nd_op import latnd_from_spec

    dims = (13, 9, 128)
    prob_j = amg.poisson(dims, lattice=True)
    with jax_env(**BF16):
        A_j = from_j(prob_j.spec, jnp.float32)
    sweep = amg.SymmetricSweep() if bwd else amg.ForwardSweep()
    masked = _build_smoother_cache(amg.GaussSeidel(ordering="multicolor", sweep=sweep), prob_j, A_j, np.float32)
    cache_j = build_j(prob_j.spec, A_j.rows_padded, jnp.float32, 1.0, 1, fwd, bwd, interpret=True, fallback=masked,
                      coef_dtype=jnp.bfloat16)
    assert isinstance(cache_j, Sweep3DCache) and str(cache_j.planes[0].dtype) == "bfloat16"
    prob = amt.poisson(dims, lattice=True)
    A = latnd_from_spec(prob.spec, torch.float32, "cpu", coef_dtype=torch.bfloat16)
    dinv = torch.zeros(A.rows_padded)
    dinv[: A.shape[0]] = torch.as_tensor(1.0 / prob.spec.diagonal())
    tab, nc = lattice_coloring_nd(prob.spec)
    cache = build_sweep3d_cache(A, dinv, tab, nc, 1.0, 1, fwd, bwd)
    assert cache.steps == cache_j.steps and cache.A.data.dtype == torch.bfloat16
    assert cache.march == plan_march(cache.dims, cache.offsets, len(cache.steps), 4)[0]
    with pytest.raises(ValueError, match="halo-tile"):
        tile_view(cache)
    n = int(np.prod(dims))
    x, b = _vec(n, A.rows_padded, 5, np.float32), _vec(n, A.rows_padded, 6, np.float32)
    want = np.asarray(smooth_j(cache_j, jnp.asarray(x), jnp.asarray(b)))
    got = smooth_sweep3d(cache, torch.as_tensor(x), torch.as_tensor(b))
    assert got.dtype == torch.float32 and rel_err(got.numpy()[:n], want[:n]) < 1e-5


def test_cg_device_3d_with_bf16_planes_matches_jax_iterations(problem3):
    """``cg_device`` in float32 with bf16 LatND planes (L0's K7 on them,
    the port's plain version) takes the JAX package's iterations (its
    masked sweep on the same planes)."""
    from algebraicmultigrid_tpu.models.device import cg_device as cg_j
    from algebraicmultigrid_tpu_torch.ops.kernels.sweep3d import Sweep3DCache

    ml_j, ml_t = problem3
    n = ml_t.levels[0].A.shape[0]
    b = np.random.default_rng(2).standard_normal(n)
    with jax_env(**BF16):
        _, it_j, _ = cg_j(ml_j, b, dtype="float32", log=True)
    x, it_t, nr_t = amt.cg_device(ml_t, b, device="cpu", dtype=torch.float32, log=True, coef_dtype=torch.bfloat16)
    h = amt.get_device_hierarchy(ml_t, "cpu", torch.float32, coef_dtype=torch.bfloat16)
    assert h.levels[0].A.data.dtype == torch.bfloat16 and isinstance(h.levels[0].pre, Sweep3DCache)
    assert it_t == it_j
    assert nr_t <= 1e-8 * np.linalg.norm(b)


def test_convert_carries_bf16_latnd_planes(problem3):
    """The JAX float32 hierarchy with bf16 LatND planes carried across
    (planes as float32 arrays of bf16 values, rounded on arrival under
    ``coef_dtype``): the port's own planes, bitwise, and its V-cycle."""
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration
    from torch_port_common import jax_basis_to_numpy

    ml_j, ml_t = problem3
    with jax_env(**BF16):
        h_j = build_j(ml_j, dtype=jnp.float32)
    levels, coarse = jax_hierarchy_to_numpy(h_j)
    assert str(levels[0]["A"]["data"].dtype) == "bfloat16"
    levels = [dict(L, **{op: dict(L[op], data=_as(L[op]["data"], np.float32))
                         for op in ("A", "P", "R") if L[op].get("format") == "LatND"}) for L in levels]
    conv = hierarchy_from_numpy(levels, coarse, device="cpu", dtype=torch.float32, coef_dtype=torch.bfloat16,
                                **jax_basis_to_numpy(h_j))
    own = _build(ml_t, torch.float32)
    for op in ("A", "P", "R"):
        a, b = getattr(conv.levels[0], op), getattr(own.levels[0], op)
        assert a.data.dtype == torch.bfloat16 and a.dtype == torch.float32 and torch.equal(a.data, b.data)
    n = ml_t.levels[0].A.shape[0]
    b = torch.as_tensor(_vec(n, own.fine_padded, 7, np.float32))
    x_conv = _one_iteration(conv, amt.V(), torch.zeros_like(b), b)
    x_own = _one_iteration(own, amt.V(), torch.zeros_like(b), b)
    assert rel_err(x_conv, x_own) < 1e-6


def test_subcycle_with_bf16_planes_still_raises(problem):
    """K9 takes bf16 planes now: ``build_device_hierarchy``, which raised
    before K9 had them, builds the subcycle on bf16 A, T and S under float32 and float64
    (D⁻¹ at the working dtype) and does not fall back to other planes
    (tests/test_torch_subcycle_bf16.py holds them against the JAX
    package)."""
    _, ml_t, _, _, _, _ = problem
    for dtype in (torch.float32, F64):
        h = _build(ml_t, dtype, tail_max_rows=600, subcycle=True)
        assert h.sub_start == 1
        for L in h.sub.levels:
            assert (L.A.dtype, L.T.dtype, L.S.dtype, L.dinv.dtype) == (torch.bfloat16,) * 3 + (dtype,)
