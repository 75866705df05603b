"""The fused V-cycle legs (K1 down, K2 up): the port's plain versions
against the JAX package's Pallas kernels in interpret mode, in float32 to
relative 1e-5 (the bound tests/test_fused_legs.py holds the JAX kernels
to), and the kernel build command.  The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_cuda.py."""

import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import jax_env, rel_err, setup_both

TOL = 1e-5
LEVELS = [0, 1, 2, 3]
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def legs():
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy as build_t

    ml_j, ml_t = setup_both()
    with jax_env(AMG_PALLAS_FUSED="1"):
        h_j = build_j(ml_j, dtype=jnp.float32)
    h_t = build_t(ml_t, device="cpu", dtype=torch.float32, tail=False)
    assert all(L.fused is not None for L in h_j.levels)
    assert all(L.fused is not None for L in h_t.levels)
    return h_j, h_t


def _vec(n, pad, seed):
    v = np.zeros(pad, np.float32)
    v[:n] = np.random.default_rng(seed).standard_normal(n)
    return v


@pytest.mark.parametrize("x_zero", [False, True])
@pytest.mark.parametrize("lvl", LEVELS)
def test_fused_down_matches_jax_kernel(legs, lvl, x_zero):
    from algebraicmultigrid_tpu.ops.pallas.vcycle_kernels import fused_down as down_j
    from algebraicmultigrid_tpu_torch.ops.kernels.vcycle_legs import fused_down_reference

    h_j, h_t = legs
    Lj, Lt = h_j.levels[lvl], h_t.levels[lvl]
    n, pad = Lj.A.shape[0], Lj.A.rows_padded
    x = np.zeros(pad, np.float32) if x_zero else _vec(n, pad, lvl)
    b = _vec(n, pad, 100 + lvl)
    xj, bcj = down_j(Lj.fused, jnp.asarray(x), jnp.asarray(b), x_zero=x_zero)
    xt, bct = fused_down_reference(Lt.fused, torch.as_tensor(x), torch.as_tensor(b), x_zero=x_zero)
    assert xt.shape == (pad,) and bct.shape == np.asarray(bcj).shape
    assert rel_err(xt, xj) < TOL
    assert rel_err(bct, bcj) < TOL


@pytest.mark.parametrize("lvl", LEVELS)
def test_fused_up_matches_jax_kernel(legs, lvl):
    from algebraicmultigrid_tpu.ops.pallas.vcycle_kernels import fused_up as up_j
    from algebraicmultigrid_tpu_torch.ops.kernels.vcycle_legs import fused_up_reference

    h_j, h_t = legs
    Lj, Lt = h_j.levels[lvl], h_t.levels[lvl]
    n, pad = Lj.A.shape[0], Lj.A.rows_padded
    nc = Lj.R.shape[0]
    x, b, xc = _vec(n, pad, 200 + lvl), _vec(n, pad, 300 + lvl), _vec(nc, nc, 400 + lvl)
    xj = up_j(Lj.fused, jnp.asarray(x), jnp.asarray(b), jnp.asarray(xc), out_len=pad)
    xt = fused_up_reference(Lt.fused, torch.as_tensor(x), torch.as_tensor(b), torch.as_tensor(xc))
    assert xt.shape == (pad,)
    assert rel_err(xt, xj) < TOL


@pytest.mark.parametrize("lvl", LEVELS)
def test_fused_legs_match_jax_unfused_ops(legs, lvl):
    """down == presmooth + R·(b − A·x), up == postsmooth(x + P·x_c) through
    the JAX package's unfused smoother and mat_vec."""
    from algebraicmultigrid_tpu.models.device import _apply_smoother, fit_len
    from algebraicmultigrid_tpu.ops.banded import mat_vec
    from algebraicmultigrid_tpu_torch.ops.kernels.vcycle_legs import (
        fused_down_reference,
        fused_up_reference,
    )

    h_j, h_t = legs
    Lj, Lt = h_j.levels[lvl], h_t.levels[lvl]
    n, pad = Lj.A.shape[0], Lj.A.rows_padded
    x, b = jnp.asarray(_vec(n, pad, 500 + lvl)), jnp.asarray(_vec(n, pad, 600 + lvl))
    xs = _apply_smoother(Lj.pre, Lj.A, x, b)
    bc = mat_vec(Lj.R, b - fit_len(mat_vec(Lj.A, xs), pad))
    xd, bct = fused_down_reference(Lt.fused, torch.tensor(np.asarray(x)), torch.tensor(np.asarray(b)))
    assert rel_err(xd, xs) < TOL
    nc = Lj.R.shape[0]
    assert rel_err(bct, np.asarray(bc)[:nc]) < TOL

    xc = jnp.asarray(_vec(nc, nc, 700 + lvl))
    xu = _apply_smoother(Lj.post, Lj.A, xs + fit_len(mat_vec(Lj.P, xc), pad), b)
    xut = fused_up_reference(Lt.fused, xd, torch.tensor(np.asarray(b)), torch.tensor(np.asarray(xc)))
    assert rel_err(xut, xu) < TOL


def test_cpu_wrappers_take_the_plain_version(legs):
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    _, h_t = legs
    L = h_t.levels[0]
    n, pad = L.A.shape[0], L.A.rows_padded
    x, b = torch.as_tensor(_vec(n, pad, 1)), torch.as_tensor(_vec(n, pad, 2))
    before = dict(vl.launches)
    xd, bc = vl.fused_down(L.fused, x, b)
    xr, bcr = vl.fused_down_reference(L.fused, x, b)
    assert torch.equal(xd, xr) and torch.equal(bc, bcr)
    xu = vl.fused_up(L.fused, xd, b, bc)
    assert torch.equal(xu, vl.fused_up_reference(L.fused, xd, b, bc))
    assert vl.launches == before


def test_build_command_targets_sm90a_in_ignored_dir():
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    out = vl.library_path()
    obj = vl.BUILD_DIR / "x.o"
    for cmd in [vl.compile_command(f, obj) for f in vl.SOURCES] + [vl.link_command([obj], out)]:
        assert cmd[0].endswith("nvcc")
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert all(f.exists() and str(f) in vl.compile_command(f, obj) for f in vl.SOURCES)
    link = vl.link_command([obj], out)
    assert "-shared" in link and str(obj) in link
    assert out.parent == vl.BUILD_DIR and str(out) in link
    rel = out.relative_to(REPO)
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", str(rel)], cwd=REPO, capture_output=True
    )
    assert ignored.returncode == 0, f"{rel} is not ignored by git"
