"""bf16 coefficient planes under float64 vectors (``coef_dtype=torch.bfloat16``;
the JAX package's ``AMG_COEF_DTYPE=bfloat16`` with x64), the cycles held
against the JAX package on the 192² structured-SA problem: three fixed
cycles on the JAX hierarchy carried across against three JAX cycles to
1e-10, and the refined solve with the JAX inner solve's PCG iterations.
The planes and the kernels: tests/test_torch_bf16_f64.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from torch_port_common import N, PLAIN_TILES, jax_env, jax_hierarchy_to_numpy, rel_err, setup_both

TOL = 1e-10
BF16 = dict(AMG_COEF_DTYPE="bfloat16")
PLANES = ("A", "dinv", "T", "S")
F64 = torch.float64


@pytest.fixture(scope="module")
def problem():
    """The port's host hierarchy and the JAX float64 hierarchy with bf16
    planes (legs on every level)."""
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j

    ml_j, ml_t = setup_both()
    with jax_env(**BF16, **PLAIN_TILES):
        h_legs = build_j(ml_j, dtype=jnp.float64)
    assert h_legs.tail is None and all(L.fused is not None for L in h_legs.levels)
    return ml_t, h_legs


def _vec(n, pad, seed, dtype=np.float64):
    v = np.zeros(pad, dtype)
    v[:n] = np.random.default_rng(seed).standard_normal(n)
    return v


def _as(a, dtype=np.float64):
    """A numpy array (bf16 from the JAX package) as ``dtype``."""
    return np.asarray(a).astype(dtype)


def test_fixed_cycles_match_iterated_jax_cycles(problem):
    """``run_fixed_cycles`` in float64 on the JAX hierarchy carried across
    (planes as float32 arrays of bf16 values) against three JAX V-cycles."""
    from algebraicmultigrid_tpu.models.device import _one_iteration
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy
    from algebraicmultigrid_tpu_torch.models.device import run_fixed_cycles

    _, h_j = problem
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

    ml_t, h_j = problem
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
