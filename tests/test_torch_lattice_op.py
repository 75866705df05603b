"""The port's Lat2D operators and masked multicolor sweep against the JAX
package's, in float64 to relative 1e-12, on hierarchies carried across with
``convert.hierarchy_from_numpy`` and built by the port itself."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import PLAIN_TILES, jax_basis_to_numpy, jax_env, jax_hierarchy_to_numpy, rel_err, setup_both

TOL = 1e-12


@pytest.fixture(scope="module")
def pair():
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy as build_t

    ml_j, ml_t = setup_both()
    with jax_env(**PLAIN_TILES):
        h_j = build_j(ml_j, dtype=jnp.float64)
    levels, coarse = jax_hierarchy_to_numpy(h_j)
    h_conv = hierarchy_from_numpy(levels, coarse, device="cpu", dtype=torch.float64, **jax_basis_to_numpy(h_j))
    h_own = build_t(ml_t, device="cpu", dtype=torch.float64, tail=False)
    return h_j, h_conv, h_own


def _assert_same(a, b, where):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    elif hasattr(a, "__dataclass_fields__"):
        assert type(a) is type(b), where
        for f in a.__dataclass_fields__:
            _assert_same(getattr(a, f), getattr(b, f), f"{where}.{f}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{where}[{i}]")
    else:
        assert a == b, where


def test_converted_hierarchy_equals_built(pair):
    _, h_conv, h_own = pair
    assert all(L.fused is not None for L in h_own.levels)
    _assert_same(h_conv, h_own, "h")


def _rand(n, pad, seed):
    v = np.zeros(pad)
    v[:n] = np.random.default_rng(seed).standard_normal(n)
    return v


@pytest.mark.parametrize("op", ["A", "P", "R"])
@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_lat2d_spmv_matches_jax(pair, op, lvl):
    from algebraicmultigrid_tpu.ops.banded import mat_vec as mat_vec_j
    from algebraicmultigrid_tpu_torch.ops.banded import mat_vec as mat_vec_t

    h_j, h_conv, h_own = pair
    Mj = getattr(h_j.levels[lvl], op)
    x = _rand(Mj.shape[1], Mj.shape[1] + 5, seed=lvl)
    y_j = np.asarray(mat_vec_j(Mj, jnp.asarray(x, dtype=jnp.float64)))
    for h in (h_conv, h_own):
        y_t = mat_vec_t(getattr(h.levels[lvl], op), torch.as_tensor(x)).numpy()
        assert y_t.shape == y_j.shape
        assert rel_err(y_t, y_j) < TOL


@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_masked_sweep_matches_jax(pair, lvl):
    from algebraicmultigrid_tpu.models.device import _smooth_masked_multicolor as sweep_j
    from algebraicmultigrid_tpu_torch.models.device import _smooth_masked_multicolor as sweep_t

    h_j, h_conv, h_own = pair
    Lj = h_j.levels[lvl]
    n, pad = Lj.A.shape[0], Lj.A.rows_padded
    x, b = _rand(n, pad, 10 + lvl), _rand(n, pad, 20 + lvl)
    out_j = np.asarray(sweep_j(Lj.pre, Lj.A, jnp.asarray(x), jnp.asarray(b)))
    for h in (h_conv, h_own):
        L = h.levels[lvl]
        out_t = sweep_t(L.pre, L.A, torch.as_tensor(x), torch.as_tensor(b)).numpy()
        assert rel_err(out_t, out_j) < TOL


def test_mat_vec_rejects_other_formats():
    from algebraicmultigrid_tpu_torch.ops.banded import mat_vec

    with pytest.raises(TypeError):
        mat_vec(torch.eye(3), torch.ones(3))
