"""bf16 coefficient planes on 3-D lattices (``coef_dtype=torch.bfloat16``;
the JAX package's ``AMG_COEF_DTYPE=bfloat16`` on LatND levels under
float32), held against the JAX package: LatND planes in bf16 bitwise equal
to the JAX package's under float32 and kept at float64 under float64; the
LatND SpMV with bf16 planes to 1e-6; K7's plain version on bf16 planes
against the JAX K7 in interpret mode to 1e-5; ``cg_device`` with the
iterations of the JAX package's; the JAX hierarchy's bf16 LatND planes
carried across by ``convert.hierarchy_from_numpy``.  Float64 vectors with
bf16 planes: tests/test_torch_bf16_f64.py.

The CUDA entry ``amg_sweep3d_march_f32_bf16`` is held against these plain
versions on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from torch_port_common import jax_env, jax_hierarchy_to_numpy, rel_err

BF16 = dict(AMG_COEF_DTYPE="bfloat16")
F64 = torch.float64
# a small 3-D problem whose L0 is a LatND level (tests/test_torch_lattice_nd.py's
# setup at 32³)
DIMS3 = (32, 32, 32)
KW3 = dict(proxy=12, cut_rows=2000, min_proxy_dim=9)


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
