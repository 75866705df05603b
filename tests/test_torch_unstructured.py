"""The port's unstructured path against the JAX package's, on the CPU:
``smoothed_aggregation`` / ``ruge_stuben`` on a scipy matrix →
``build_device_hierarchy`` → the solve drivers.

* The lowering picks the same format, smoother cache, padding, color
  count and RCM basis per level (scrambled Poisson 48², natural order,
  and 96², where the fine level adopts the RCM basis), float32.
* float64 cycles agree to 1e-10 (relative, max-abs) — SA on scrambled
  48² (every level ELL: BSG refuses float64; gathered multicolor and
  natural-order GS), RS on the ``randlap`` fixture, and SA with a
  near-null space on ``lin_elastic_2d`` — both on the port's own lowering
  and on the JAX hierarchy's arrays carried across by
  ``convert.hierarchy_from_numpy``.
* float32 cycles in the RCM basis agree to 1e-5 (relative, 2-norm) at
  scrambled 96², where BSG, π folded into P/R and the masked multicolor
  caches of the permuted matrix all run; the input is the same vector in
  the JAX hierarchy's basis, and the port's ``device_cycle_fn`` enters and
  leaves it around the cycle.
* float64 ``solve_device(log=True)`` gives the same residual history.

The float32 solves are in ``tests/test_torch_unstructured_solve.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
from algebraicmultigrid_tpu.models import device as jdev

import algebraicmultigrid_tpu_torch as amt
from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy
from algebraicmultigrid_tpu_torch.models import device as tdev

from torch_port_common import both_unstructured as _both
from torch_port_common import jax_basis_to_numpy, jax_hierarchy_to_numpy, rel_err

F64_TOL = 1e-10
F32_TOL = 1e-5


def _colors(c):
    if hasattr(c, "n_colors"):
        return int(c.n_colors)
    if hasattr(c, "sizes"):
        return len(c.sizes)
    if hasattr(c, "rows"):  # the JAX gathered multicolor cache
        return int(c.rows.shape[0])
    return None


@pytest.mark.parametrize("name", ["sa48", "sa96"])
def test_lowering_matches_jax_float32(name):
    ml_j, ml_t, A = _both(name)
    h_j = jdev.build_device_hierarchy(ml_j, jnp.float32)
    h_t = tdev.build_device_hierarchy(ml_t, device="cpu", dtype=torch.float32)
    assert len(h_t.levels) == len(h_j.levels)
    for L_t, L_j in zip(h_t.levels, h_j.levels):
        for f in ("A", "P", "R", "pre", "post"):
            assert type(getattr(L_t, f)).__name__ == type(getattr(L_j, f)).__name__, f
        for f in ("A", "P", "R"):
            assert getattr(L_t, f).rows_padded == getattr(L_j, f).rows_padded, f
        assert _colors(L_t.pre) == _colors(L_j.pre)
    assert type(h_t.final_A).__name__ == type(h_j.final_A).__name__
    assert (h_t.perm0 is None) == (h_j.perm0 is None)
    if name == "sa96":
        assert h_t.perm0 is not None and type(h_t.levels[0].A).__name__ == "BSG"
        assert np.array_equal(h_t.perm0.numpy(), np.asarray(h_j.perm0))
        assert np.array_equal(h_t.iperm0.numpy(), np.asarray(h_j.iperm0))
        assert np.array_equal(h_t.levels[0].A.off.numpy(), np.asarray(h_j.levels[0].A.off))


@pytest.mark.parametrize("name", ["sa48", "rs_randlap", "sa_elastic"])
def test_cycles_match_jax_float64(name):
    ml_j, ml_t, A = _both(name)
    n = A.shape[0]
    b = np.random.default_rng(2).standard_normal(n)
    h_j = jdev.build_device_hierarchy(ml_j, jnp.float64)
    levels, coarse = jax_hierarchy_to_numpy(h_j)
    ports = {
        "own": tdev.build_device_hierarchy(ml_t, device="cpu", dtype=torch.float64),
        "converted": hierarchy_from_numpy(levels, coarse, device="cpu", dtype=torch.float64,
                                          **jax_basis_to_numpy(h_j)),
    }
    bp = np.zeros(h_j.fine_padded)
    bp[:n] = b
    x_j = jnp.zeros(h_j.fine_padded)
    refs = []
    for _ in range(2):
        x_j = jdev._one_iteration(h_j, amg.V(), x_j, jnp.asarray(bp))
        refs.append(np.asarray(x_j))
    for key, h in ports.items():
        x = torch.zeros(h.fine_padded, dtype=torch.float64)
        for ref in refs:
            x = tdev._one_iteration(h, amt.V(), x, torch.as_tensor(bp))
            assert rel_err(x.numpy(), ref) < F64_TOL, key


def test_rcm_basis_cycles_match_jax_float32():
    ml_j, ml_t, A = _both("sa96")
    n = A.shape[0]
    h_j = jdev._get_device_hierarchy(ml_j, jnp.float32)
    h_t = tdev.get_device_hierarchy(ml_t, device="cpu", dtype=torch.float32)
    assert h_j.perm0 is not None and type(h_t.levels[0].A).__name__ == "BSG"
    b = np.zeros(h_j.fine_padded, dtype=np.float32)
    b[:n] = np.random.default_rng(6).standard_normal(n)
    bq = np.array(jdev._enter_basis(h_j, jnp.asarray(b)))
    x_j = jnp.zeros(h_j.fine_padded, dtype=jnp.float32)
    x_t = torch.zeros(h_t.fine_padded, dtype=torch.float32)
    for _ in range(2):
        x_j = jdev._one_iteration(h_j, amg.V(), x_j, jnp.asarray(bq))
        x_t = tdev._one_iteration(h_t, amt.V(), x_t, torch.as_tensor(bq))
        ref = np.asarray(x_j, dtype=np.float64)
        assert np.linalg.norm(x_t.double().numpy() - ref) <= F32_TOL * np.linalg.norm(ref)
    # one cycle from the caller's ordering: the port enters and leaves the
    # basis around the cycle, as the JAX package's solve drivers do
    x1 = jdev._one_iteration(h_j, amg.V(), jnp.zeros_like(x_j), jnp.asarray(bq))
    z_j = np.asarray(jdev._exit_basis(h_j, x1), dtype=np.float64)[:n]
    z_t = amt.device_cycle_fn(ml_t, device="cpu", dtype=torch.float32)(b[:n]).double().numpy()
    assert np.linalg.norm(z_t - z_j) <= F32_TOL * np.linalg.norm(z_j)


@pytest.mark.parametrize("name", ["sa48", "rs_randlap"])
def test_logged_solve_matches_jax_float64(name):
    ml_j, ml_t, A = _both(name)
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    x_j, res_j = jdev.solve_device(ml_j, b, dtype=jnp.float64, log=True, maxiter=4)
    x_t, res_t = amt.solve_device(ml_t, b, device="cpu", dtype=torch.float64, log=True, maxiter=4)
    assert len(res_t) == len(res_j) == 5
    assert np.allclose(res_t, res_j, rtol=F64_TOL, atol=0)
    assert rel_err(x_t, x_j) < F64_TOL
