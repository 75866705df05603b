"""The phased whole-subcycle V-cycle (K9) with bf16 coefficient planes
(``subcycle=True, coef_dtype=torch.bfloat16``; the JAX package's
``AMG_PALLAS_SUB=1`` under ``AMG_COEF_DTYPE=bfloat16``), float32 and
float64, on the 192² structured-SA Poisson of ``torch_port_common`` with
the tail limited to 600 rows (L1 64² the sub level, L2 22² and L3 8² the
tail):

* the cache's planes bitwise equal to the JAX
  ``build_fused_subcycle_cache(..., coef_dtype=jnp.bfloat16)``: the top
  level's A, T and S in bf16 rounded from the working dtype and its D⁻¹ at
  the working dtype, the tail's as the JAX tail cache keeps them;
* ``fused_subcycle_reference`` against the JAX ``fused_subcycle`` in
  interpret mode (relative 1e-5 in float32, 1e-10 in float64), on the
  port's cache and on the JAX cache carried across by
  ``convert.hierarchy_from_numpy``;
* a V-cycle with the bf16 subcycle against the JAX V-cycle and against the
  same hierarchy with the tail entered at L1 (whose L1 takes the same
  planes), float64 to 1e-10; the route through L1's legs rounds L1's D⁻¹
  to bf16 from float32 (the legs' rule, in both packages), so it is held
  only to the size of that rounding.

The CUDA entries ``amg_fused_subcycle_f32_bf16`` / ``_f64_bf16`` are held
against the plain version on the card by tests/test_torch_cuda.py."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from torch_port_common import (
    N, PLAIN_TILES, jax_env, jax_hierarchy_to_numpy, jax_sub_to_numpy, jax_tail_to_numpy, rel_err, setup_both,
)

TAIL_ROWS = 600
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5), "float64": (torch.float64, jnp.float64, 1e-10)}


def _vec(n, pad, seed):
    v = np.zeros(pad)
    v[:n] = np.random.default_rng(seed).standard_normal(n)
    return v


def _f32(a):
    """bf16 (torch or ml_dtypes) or wider values as float32/float64 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _as_f32_planes(d):
    """A leg dict with its bf16 planes as float32 arrays holding bf16 values
    (``hierarchy_from_numpy``'s transport for them)."""
    return {k: _f32(v) if isinstance(v, np.ndarray) else v for k, v in d.items()}


@pytest.fixture(scope="module")
def problem():
    from algebraicmultigrid_tpu.models.device import _one_iteration
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j
    from algebraicmultigrid_tpu.ops.pallas.subcycle_kernel import fused_subcycle

    ml_j, ml_t = setup_both()
    out = types.SimpleNamespace(ml_j=ml_j, ml_t=ml_t)
    for key, (_, jdt, _) in DTYPES.items():
        with jax_env(AMG_PALLAS_TAIL="1", AMG_PALLAS_SUB="1", AMG_TAIL_MAX_ROWS=str(TAIL_ROWS),
                     AMG_COEF_DTYPE="bfloat16", **PLAIN_TILES):
            h_j = build_j(ml_j, dtype=jdt)
        L1 = h_j.levels[1].A
        b1 = _vec(L1.shape[0], L1.rows_padded, 1).astype(np.dtype(key))
        b0 = _vec(N * N, h_j.fine_padded, 2).astype(np.dtype(key))
        setattr(out, key, types.SimpleNamespace(
            h_j=h_j, b1=b1, b0=b0,
            y_sub=np.asarray(fused_subcycle(h_j.sub, jnp.asarray(b1))),
            y_cycle=np.asarray(_one_iteration(h_j, amg.V(), jnp.zeros(b0.shape[0], jdt), jnp.asarray(b0))),
        ))
    return out


def _build(ml, dtype, **kw):
    return amt.build_device_hierarchy(ml, device="cpu", dtype=dtype, tail_max_rows=TAIL_ROWS,
                                      coef_dtype=torch.bfloat16, **kw)


@pytest.fixture(scope="module")
def ports(problem):
    """Per dtype: the port's hierarchy with the bf16 subcycle, and the JAX
    hierarchy carried across with its tail and sub caches."""
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy

    out = {}
    for key, (dt, _, _) in DTYPES.items():
        h_j = getattr(problem, key).h_j
        levels, coarse = jax_hierarchy_to_numpy(h_j)
        levels = [dict(L, fused=None if L["fused"] is None else _as_f32_planes(L["fused"])) for L in levels]
        tail = jax_tail_to_numpy(h_j)
        tail = dict(tail, levels=[_as_f32_planes(d) for d in tail["levels"]])
        out[key] = types.SimpleNamespace(
            own=_build(problem.ml_t, dt, subcycle=True),
            conv=hierarchy_from_numpy(
                levels, coarse, device="cpu", dtype=dt, coef_dtype=torch.bfloat16,
                tail=tail, tail_start=h_j.tail_start, sub=_as_f32_planes(jax_sub_to_numpy(h_j)),
                sub_start=h_j.sub_start,
            ),
        )
    return out


@pytest.mark.parametrize("key", DTYPES)
def test_planes_bitwise_equal_jax_cache(problem, ports, key):
    """The top level's A, T, S in bf16 and D⁻¹ at the working dtype, and
    every tail level's planes, equal to the JAX cache's bit for bit."""
    from algebraicmultigrid_tpu.ops.pallas.subcycle_kernel import build_fused_subcycle_cache as build_sub_j

    dt, jdt, _ = DTYPES[key]
    ml_j = problem.ml_j
    with jax_env(AMG_TAIL_MAX_ROWS=str(TAIL_ROWS)):
        sub_j = build_sub_j(ml_j.levels, ml_j, 1, jdt, coef_dtype=jnp.bfloat16, interpret=True)
    h = ports[key].own
    assert (h.sub_start, h.tail_start) == (1, 2)
    top = h.sub.top
    assert top is not h.levels[1].fused  # the legs' cache rounds D⁻¹ from float32
    assert (top.A.dtype, top.T.dtype, top.S.dtype, top.dinv.dtype, top.dtype) == (torch.bfloat16,) * 3 + (dt, dt)
    want = jax_sub_to_numpy(types.SimpleNamespace(sub=sub_j, sub_start=1, levels=getattr(problem, key).h_j.levels))
    for name in ("A", "dinv", "T", "S"):
        got, ref = _f32(getattr(top, name)), _f32(want[name])
        assert got.dtype == ref.dtype and np.array_equal(got, ref), name
    tail_j = jax_tail_to_numpy(getattr(problem, key).h_j)
    for L, d in zip(h.sub.tail.levels, tail_j["levels"], strict=True):
        assert (L.A.dtype, L.dinv.dtype) == (torch.bfloat16, dt)
        for name in ("A", "dinv", "T", "S"):
            assert np.array_equal(_f32(getattr(L, name)), _f32(d[name])), name
    assert h.sub.tail.Mc.dtype == dt and h.sub.tail is h.tail


@pytest.mark.parametrize("key", DTYPES)
def test_reference_matches_jax_kernel(problem, ports, key):
    """The plain version on the port's cache and on the JAX cache carried
    across, against the JAX kernel in interpret mode; a CPU tensor runs the
    plain version and counts no launch."""
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.kernels.subcycle_kernel import fused_subcycle, fused_subcycle_reference

    tol = DTYPES[key][2]
    p = getattr(problem, key)
    b = torch.as_tensor(p.b1)
    before = dict(vl.launches)
    ys = []
    for h in (ports[key].own, ports[key].conv):
        y = fused_subcycle_reference(h.sub, b)
        assert y.shape == b.shape and y.dtype == b.dtype
        assert rel_err(y, p.y_sub[: b.shape[0]]) < tol
        assert torch.equal(fused_subcycle(h.sub, b), y)
        ys.append(y)
    assert vl.launches == before
    assert torch.equal(ys[0], ys[1])  # the carried cache is the port's own, bit for bit


def test_vcycle_matches_jax_and_the_tail_at_l1(problem, ports):
    """float64: one V-cycle with the bf16 subcycle against the JAX V-cycle
    (AMG_PALLAS_SUB=1, bf16 planes) and against the same hierarchy with the
    tail entered at L1 (no subcycle; L1 a tail level with the same planes),
    both to 1e-10; against the route through L1's bf16 legs (D⁻¹ rounded to
    bf16 from float32) only to the size of that rounding."""
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration

    p = problem.float64
    b = torch.as_tensor(p.b0)
    h = ports["float64"]
    y = _one_iteration(h.own, amt.V(), torch.zeros_like(b), b)
    assert rel_err(y, p.y_cycle) < 1e-10
    assert rel_err(_one_iteration(h.conv, amt.V(), torch.zeros_like(b), b), p.y_cycle) < 1e-10
    at_l1 = amt.build_device_hierarchy(problem.ml_t, device="cpu", dtype=torch.float64, tail_max_rows=5000,
                                       coef_dtype=torch.bfloat16)
    assert (at_l1.tail_start, at_l1.sub_start) == (1, -1)
    assert rel_err(_one_iteration(at_l1, amt.V(), torch.zeros_like(b), b), y) < 1e-10
    legs = _build(problem.ml_t, torch.float64)
    assert legs.sub is None and legs.levels[1].fused.dinv.dtype == torch.bfloat16
    assert 1e-10 < rel_err(_one_iteration(legs, amt.V(), torch.zeros_like(b), b), y) < 1e-4


def test_solve_refined_runs_the_bf16_subcycle(problem):
    """solve_refined with the bf16 subcycle reaches 1e-8 with K9's plain
    version in every V-cycle (the default tail limit of ``solve_refined``
    starts the tail at L0 at 192², so the hierarchy is put in its cache)."""
    from algebraicmultigrid_tpu_torch.models import device as dev

    ml = problem.ml_t
    b = np.random.default_rng(3).standard_normal(N * N)
    key = ("torch-hierarchy", "cpu", str(torch.float32), True, str(torch.bfloat16))
    ml._device_cache[key] = _build(ml, torch.float32, subcycle=True)
    try:
        assert dev.get_device_hierarchy(ml, "cpu", torch.float32, subcycle=True,
                                        coef_dtype=torch.bfloat16).sub_start == 1
        x, hist = amt.solve_refined(ml, b, tol=1e-8, device="cpu", log=True, subcycle=True,
                                    coef_dtype=torch.bfloat16)
    finally:
        ml._device_cache.clear()
    assert hist[-1] <= 1e-8 * hist[0] and len(hist) - 1 <= 4
    assert np.linalg.norm(b - ml.levels[0].A @ x) <= 1e-8 * np.linalg.norm(b)


def test_mixed_planes_refused(problem, ports):
    """A top level with other planes than its tail's is refused, and the
    wrapper refuses tensors on other devices."""
    from algebraicmultigrid_tpu_torch.ops.kernels.subcycle_kernel import fused_subcycle, make_fused_subcycle_cache

    own = ports["float32"].own
    f32_top = amt.build_device_hierarchy(problem.ml_t, device="cpu", dtype=torch.float32, tail_max_rows=TAIL_ROWS,
                                         subcycle=True).sub.top
    with pytest.raises(ValueError, match="planes"):
        make_fused_subcycle_cache(f32_top, own.sub.tail)
    with pytest.raises(ValueError):
        fused_subcycle(own.sub, torch.zeros(64 * 64, dtype=torch.float32, device="meta"))
