"""bf16 coefficient planes under float64 vectors (``coef_dtype=torch.bfloat16``;
the JAX package's ``AMG_COEF_DTYPE=bfloat16`` with x64), held against the
JAX package on the 192² structured-SA problem in float64: the legs' A, D⁻¹,
T and S (rounded from float32) and the whole-tail levels' A, T and S
(rounded from float64; D⁻¹ and Mc float64) bitwise equal to the JAX
package's; the plain K1–K4 on those planes against the JAX interpret-mode
kernels to 1e-10 relative; K9 building its subcycle on bf16 planes under
float32 and float64.  The cycles and the refined solve:
tests/test_torch_bf16_f64_cycles.py; the 3-D lattices with bf16 planes:
tests/test_torch_bf16_3d.py.

The CUDA entries ``*_f64_bf16`` are held against these plain versions on
the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import algebraicmultigrid_tpu_torch as amt
from torch_port_common import (
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
