"""The port's unstructured solves on the CPU, float32 (the JAX package's
cycle on the same problems: ``tests/test_torch_unstructured.py``):

* ``cg_device`` takes the same number of iterations as the JAX package's,
  with the final residual norm within float32 tolerance, at 48² and at 96²,
  where the fine level runs in the RCM basis (the JAX BSG kernel in
  interpret mode);
* at 96² the fine level runs in the RCM basis, and ``cg_device``,
  ``MultiLevel.solve(engine="torch")`` (``solve_device``) and
  ``device_cycle_fn`` take and return vectors in the caller's order;
* ``solve_refined`` reaches 1e-8 with its float64 outer residual an ELL
  SpMV on the device.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from algebraicmultigrid_tpu.models import device as jdev

import algebraicmultigrid_tpu_torch as amt
from algebraicmultigrid_tpu_torch.models import device as tdev
from algebraicmultigrid_tpu_torch.ops.sparse import ELL

from torch_port_common import both_unstructured as _both

F32_RTOL = 1e-2  # the final residual norm after ~10 float32 PCG iterations


@pytest.mark.parametrize("name", ["sa48", "sa96"])
def test_cg_matches_jax_float32(name):
    ml_j, ml_t, A = _both(name)
    b = A @ np.random.default_rng(3).standard_normal(A.shape[0])
    x_j, it_j, nr_j = jdev.cg_device(ml_j, b, tol=1e-5, dtype=jnp.float32, log=True)
    x_t, it_t, nr_t = amt.cg_device(ml_t, b, tol=1e-5, device="cpu", dtype=torch.float32, log=True)
    assert it_t == it_j
    assert abs(nr_t - nr_j) <= F32_RTOL * nr_j
    assert np.linalg.norm(b - A @ x_t) <= 1e-5 * np.linalg.norm(b) * 1.5


def test_rcm_basis_solve_in_callers_order():
    """At 96² the fine level runs in the RCM basis; cg_device, solve_device
    and device_cycle_fn take and return vectors in the caller's order."""
    _, ml_t, A = _both("sa96")
    h = tdev.get_device_hierarchy(ml_t, device="cpu", dtype=torch.float32)
    assert h.perm0 is not None
    n = A.shape[0]
    b = A @ np.ones(n)
    x = amt.cg_device(ml_t, b, tol=1e-5, device="cpu", dtype=torch.float32)
    assert np.linalg.norm(A @ x - b) <= 2e-5 * np.linalg.norm(b)
    x, res = ml_t.solve(b, engine="torch", device="cpu", dtype=torch.float32, log=True, maxiter=3)
    assert res[-1] < res[0] and np.linalg.norm(A @ x - b) == pytest.approx(res[-1], rel=1e-3)
    M = amt.device_cycle_fn(ml_t, device="cpu", dtype=torch.float32)
    z = M(b).double().numpy()
    assert np.linalg.norm(A @ z - b) < np.linalg.norm(b)


def test_solve_refined_f64_ell():
    """A scrambled fine level has no float64 SDIA or dense lowering above
    4096 rows, so the outer residual is a float64 ELL SpMV on the device."""
    _, ml_t, A = _both("sa72")
    A64 = tdev._get_fine_f64(ml_t, torch.device("cpu"))
    assert isinstance(A64, ELL) and A64.data.dtype == torch.float64
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    stats = {}
    x, hist = amt.solve_refined(ml_t, b, tol=1e-8, device="cpu", log=True, stats=stats)
    assert len(hist) - 1 <= 4 and hist[-1] <= 1e-8 * hist[0]
    assert np.linalg.norm(b - A @ x) <= 1e-8 * np.linalg.norm(b)
    assert len(stats["inner_iters"]) == len(hist) - 1
