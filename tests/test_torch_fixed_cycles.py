"""The port's ``run_fixed_cycles`` (the cross-cycle updown loop) against
iterated JAX V-cycles, in float64 to relative 1e-10: three cycles from x = 0
through the port's plain versions on the JAX fused-leg hierarchy (no tail)
carried across, against three JAX ``_one_iteration`` calls with the Pallas
legs in interpret mode (jitted once: the interpreted kernels then run as
compiled XLA, ~0.03 s a cycle against ~9 s eagerly)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
from torch_port_common import N, PLAIN_TILES, jax_env, jax_hierarchy_to_numpy, rel_err, setup_both

CYCLES = 3


@pytest.fixture(scope="module")
def pair():
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy

    ml_j, _ = setup_both()
    with jax_env(**PLAIN_TILES):
        h_j = build_j(ml_j, dtype=jnp.float64)
    assert h_j.tail is None and all(L.fused is not None for L in h_j.levels)
    levels, coarse = jax_hierarchy_to_numpy(h_j)
    return h_j, hierarchy_from_numpy(levels, coarse, device="cpu", dtype=torch.float64)


def test_run_fixed_cycles_matches_iterated_jax_cycles(pair):
    from algebraicmultigrid_tpu.models.device import _one_iteration
    from algebraicmultigrid_tpu_torch.models.device import run_fixed_cycles

    h_j, h_t = pair
    b = np.zeros(h_j.fine_padded)
    b[: N * N] = np.random.default_rng(3).standard_normal(N * N)
    cycle = jax.jit(lambda h, x, b: _one_iteration(h, amg.V(), x, b))
    x_j = jnp.zeros(b.shape[0])
    for _ in range(CYCLES):
        x_j = cycle(h_j, x_j, jnp.asarray(b))
    x_t = run_fixed_cycles(h_t, torch.zeros(b.shape[0], dtype=torch.float64), torch.as_tensor(b), CYCLES)
    assert x_t.shape == (h_j.fine_padded,)
    assert rel_err(x_t, x_j) < 1e-10
