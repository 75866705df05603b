"""The whole-tail V-cycle (K4) and the cross-cycle updown leg (K3): the
port's plain versions against the JAX package's Pallas kernels in interpret
mode (K4 in float64 to relative 1e-10, K3 in float32 to relative 1e-5), the
tail's wiring into the cycle, and the kernel build command.  The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import algebraicmultigrid_tpu_torch as amt
from torch_port_common import N, PLAIN_TILES, jax_env, jax_tail_to_numpy, rel_err, setup_both

JAX_TAIL_ROWS = "5000"  # tests/test_fused_tail.py's setting: the tail starts at L1


@pytest.fixture(scope="module")
def problem():
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j

    ml_j, ml_t = setup_both()
    with jax_env(AMG_PALLAS_TAIL="1", AMG_TAIL_MAX_ROWS=JAX_TAIL_ROWS):
        h_tail_j = build_j(ml_j, dtype=jnp.float64)
    return ml_j, ml_t, h_tail_j


def _build(ml, **kw):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy

    return build_device_hierarchy(ml, device="cpu", **kw)


def _vec(n, pad, seed, dtype=np.float64):
    v = np.zeros(pad, dtype)
    v[:n] = np.random.default_rng(seed).standard_normal(n)
    return v


def test_tail_start_matches_jax(problem):
    _, ml_t, h_tail_j = problem
    h = _build(ml_t, dtype=torch.float64, tail_max_rows=int(JAX_TAIL_ROWS))
    assert h.tail_start == h_tail_j.tail_start == 1
    assert len(h.tail.levels) == len(h_tail_j.tail.metas) == len(ml_t.levels) - 1
    assert h.levels[0].fused is not None
    assert all(L.fused is None for L in h.levels[1:])
    full = _build(ml_t, dtype=torch.float64)
    assert full.tail_start == 0 and all(L.fused is None for L in full.levels)
    assert _build(ml_t, dtype=torch.float64, tail=False).tail is None


@pytest.mark.parametrize("x_zero", [True, False])
def test_fused_tail_matches_jax_kernel(problem, x_zero):
    """The port's K4 plain version, on the JAX tail cache carried across
    and on the port's own, against JAX ``fused_tail``."""
    from algebraicmultigrid_tpu.ops.pallas.tail_kernel import fused_tail as tail_j
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy
    from algebraicmultigrid_tpu_torch.ops.kernels.tail_kernel import fused_tail_reference
    from torch_port_common import jax_hierarchy_to_numpy

    _, ml_t, h_j = problem
    levels, coarse = jax_hierarchy_to_numpy(h_j)
    conv = hierarchy_from_numpy(
        levels, coarse, device="cpu", dtype=torch.float64,
        tail=jax_tail_to_numpy(h_j), tail_start=h_j.tail_start,
    )
    own = _build(ml_t, dtype=torch.float64, tail_max_rows=int(JAX_TAIL_ROWS))
    L1 = h_j.levels[1].A
    n, pad = L1.shape[0], L1.rows_padded
    x = np.zeros(pad) if x_zero else _vec(n, pad, 1)
    b = _vec(n, pad, 2)
    y_j = np.asarray(tail_j(h_j.tail, jnp.asarray(x), jnp.asarray(b), x_zero=x_zero))
    for h in (conv, own):
        assert h.tail_start == 1
        y = fused_tail_reference(h.tail, torch.as_tensor(x), torch.as_tensor(b), x_zero=x_zero)
        assert y.shape == (pad,)
        assert rel_err(y, y_j) < 1e-10


def test_fused_updown_matches_jax_kernel(problem):
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j
    from algebraicmultigrid_tpu.ops.pallas.vcycle_kernels import fused_updown as updown_j
    from algebraicmultigrid_tpu_torch.ops.kernels.vcycle_legs import fused_updown_reference

    ml_j, ml_t, _ = problem
    with jax_env(**PLAIN_TILES):
        h_j = build_j(ml_j, dtype=jnp.float32)
    h_t = _build(ml_t, dtype=torch.float32, tail=False)
    Lj, Lt = h_j.levels[0], h_t.levels[0]
    n, pad, nc = Lj.A.shape[0], Lj.A.rows_padded, Lj.R.shape[0]
    x, b, xc = (_vec(m, p, s, np.float32) for m, p, s in ((n, pad, 3), (n, pad, 4), (nc, nc, 5)))
    xj, bcj = updown_j(Lj.fused, jnp.asarray(x), jnp.asarray(b), jnp.asarray(xc))
    xt, bct = fused_updown_reference(Lt.fused, torch.as_tensor(x), torch.as_tensor(b), torch.as_tensor(xc))
    assert xt.shape == (pad,) and bct.shape == (nc,)
    assert rel_err(xt, np.asarray(xj)[:pad]) < 1e-5
    assert rel_err(bct, bcj) < 1e-5


@pytest.mark.parametrize("lvl", [0, 1])
def test_fused_updown_is_up_then_down(problem, lvl):
    """K3 == K2 followed by K1: at ω = 1 the deduped boundary step of the
    double sweep changes only the rounding."""
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    _, ml_t, _ = problem
    L = _build(ml_t, dtype=torch.float64, tail=False).levels[lvl]
    assert L.fused.omega == 1.0 and len(L.fused.steps2) == 2 * len(L.fused.steps) - 1
    n, pad, nc = L.A.shape[0], L.A.rows_padded, L.R.shape[0]
    x, b, xc = (torch.as_tensor(_vec(m, p, s)) for m, p, s in ((n, pad, 6), (n, pad, 7), (nc, nc, 8)))
    xu = vl.fused_up_reference(L.fused, x, b, xc)
    xd, bc = vl.fused_down_reference(L.fused, xu, b)
    xo, bco = vl.fused_updown(L.fused, x, b, xc)
    assert rel_err(xo, xd) < 1e-12 and rel_err(bco, bc) < 1e-12


def test_steps2_list():
    from algebraicmultigrid_tpu.ops.pallas.vcycle_kernels import _steps2_list
    from algebraicmultigrid_tpu_torch.ops.coloring import steps2_list

    for args in ((2, 1, True, True, 1.0), (4, 1, True, True, 1.0), (4, 2, True, True, 1.2),
                 (3, 1, True, False, 1.0), (4, 1, False, True, 1.0)):
        assert steps2_list(*args) == _steps2_list(*args)
    assert steps2_list(2, 1, True, True) == (0, 1, 0, 1, 0)


@pytest.mark.parametrize("cyc", ["V", "W", "F"])
def test_cycles_with_tail_match_unfused(problem, cyc):
    """V-cycles enter the tail; W-cycles fall back to masked sweeps on the
    levels it covers; F-cycles do both.  All match the unfused cycle."""
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration

    _, ml_t, _ = problem
    plain = _build(ml_t, dtype=torch.float64, fused=False, tail=False)
    b = torch.as_tensor(_vec(N * N, plain.fine_padded, 9))
    ref = _one_iteration(plain, getattr(amt, cyc)(), torch.zeros_like(b), b)
    for rows in (5000, 250_000):
        h = _build(ml_t, dtype=torch.float64, tail_max_rows=rows)
        assert h.tail is not None
        got = _one_iteration(h, getattr(amt, cyc)(), torch.zeros_like(b), b)
        assert rel_err(got, ref) < 1e-10


def test_cpu_tail_wrapper_takes_the_plain_version(problem):
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.kernels.tail_kernel import fused_tail, fused_tail_reference

    _, ml_t, _ = problem
    h = _build(ml_t, dtype=torch.float32)
    assert h.tail.desc is None
    b = torch.as_tensor(_vec(N * N, h.fine_padded, 10, np.float32))
    before = dict(vl.launches)
    got = fused_tail(h.tail, torch.zeros_like(b), b, x_zero=True)
    assert torch.equal(got, fused_tail_reference(h.tail, torch.zeros_like(b), b, x_zero=True))
    assert vl.launches == before


def test_build_command_lists_both_sources():
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    names = [f.name for f in vl.SOURCES]
    assert names == [
        "vcycle_legs.cu", "tail_kernel.cu", "tail_nf_kernel.cu", "subcycle_kernel.cu", "bsg_spmv.cu", "scan_gs.cu",
        "gs_sweep.cu", "sweep3d.cu", "halo_stencil.cu",
    ]
    for f in vl.SOURCES:
        cmd = vl.compile_command(f, vl.BUILD_DIR / "x.o")
        assert f.exists() and str(f) in cmd and "-c" in cmd
        assert cmd.count("-gencode") == 1 and "arch=compute_90a,code=sm_90a" in cmd
    assert [f.name for f in vl.HEADERS] == [
        "stencil.cuh", "leg_tile.cuh", "updown_stage.cuh", "tail_levels.cuh", "sweep_tile.cuh", "sweep_march.cuh",
    ]
    assert all(f.exists() for f in vl.HEADERS)
