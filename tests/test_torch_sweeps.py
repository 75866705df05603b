"""The whole-sweep kernels' plain versions against the JAX package: K7's
against ``smooth_sweep3d`` in interpret mode and against the masked sweep,
K5's against ``smooth_pallas_gs`` in interpret mode, both to 2e-6 relative
in float32; where the device builder runs them (K5 on Lat2D levels with
neither legs nor tail, K7 on 3-D levels), and one V-cycle of a forward /
backward GS hierarchy, whose Lat2D levels all run K5, against the JAX
package's in float64."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt
from torch_port_common import SETUP_KW, rel_err, setup_both

RTOL = 2e-6
SYM = (True, True)
FWD_BWD = [(True, False), (False, True)]


def _vectors(n, pad, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros(pad, np.float32)
    b = np.zeros(pad, np.float32)
    x[:n] = rng.standard_normal(n)
    b[:n] = rng.standard_normal(n)
    return x, b


def _assert_k5_march(cache, row_dims):
    """K5's cache plans the march on the level as the grid (Wx, 1, Wy)."""
    from algebraicmultigrid_tpu_torch.ops.kernels.tiled_sweep import plan_march

    Wx, Wy = row_dims
    assert cache.dims == (Wx, 1, Wy) and cache.box is None and cache.march is not None
    want, _ = plan_march(cache.dims, cache.offsets, len(cache.steps), cache.A.data.element_size())
    assert cache.march == want and cache.march.box[0] == 1


def _port_dinv(spec, pad, dtype=torch.float32):
    d = torch.zeros(pad, dtype=dtype)
    d[: spec.diagonal().shape[0]] = torch.as_tensor(1.0 / spec.diagonal())
    return d


def _k7(dims, fwd, bwd):
    from algebraicmultigrid_tpu_torch.models.lattice_nd import lattice_coloring_nd
    from algebraicmultigrid_tpu_torch.ops.kernels.sweep3d import build_sweep3d_cache
    from algebraicmultigrid_tpu_torch.ops.lattice_nd_op import latnd_from_spec

    prob = amt.poisson(dims, lattice=True)
    A = latnd_from_spec(prob.spec, torch.float32, "cpu")
    tab, nc = lattice_coloring_nd(prob.spec)
    return build_sweep3d_cache(A, _port_dinv(prob.spec, A.rows_padded), tab, nc, 1.0, 1, fwd, bwd)


@pytest.mark.parametrize("fwd,bwd", [SYM] + FWD_BWD)
def test_k7_plain_matches_jax_kernel(fwd, bwd):
    """On (13, 9, 128), the shape of tests/test_sweep3d.py (nz a lane
    multiple, as the TPU kernel needs), in interpret mode."""
    from algebraicmultigrid_tpu.models.device import _build_smoother_cache
    from algebraicmultigrid_tpu.ops.lattice_nd_op import latnd_from_spec
    from algebraicmultigrid_tpu.ops.pallas.sweep3d_kernel import Sweep3DCache, build_sweep3d_cache, smooth_sweep3d
    from algebraicmultigrid_tpu_torch.ops.kernels.sweep3d import smooth_sweep3d as smooth_t

    dims = (13, 9, 128)
    prob = amg.poisson(dims, lattice=True)
    A_j = latnd_from_spec(prob.spec, jnp.float32)
    sweep = amg.SymmetricSweep() if fwd and bwd else (amg.ForwardSweep() if fwd else amg.BackwardSweep())
    masked = _build_smoother_cache(amg.GaussSeidel(ordering="multicolor", sweep=sweep), prob, A_j, np.float32)
    cache_j = build_sweep3d_cache(
        prob.spec, A_j.rows_padded, jnp.float32, 1.0, 1, fwd, bwd, interpret=True, fallback=masked
    )
    assert isinstance(cache_j, Sweep3DCache)
    cache_t = _k7(dims, fwd, bwd)
    assert cache_t.steps == cache_j.steps
    n = int(np.prod(dims))
    x, b = _vectors(n, A_j.rows_padded)
    want = np.asarray(smooth_sweep3d(cache_j, jnp.asarray(x), jnp.asarray(b)))
    got = smooth_t(cache_t, torch.as_tensor(x), torch.as_tensor(b)).numpy()
    assert rel_err(got[:n], want[:n]) < RTOL


@pytest.mark.parametrize("dims", [(13, 9, 20), (5, 3, 4)])
def test_k7_plain_matches_jax_masked_sweep(dims):
    """On grids the TPU kernel does not take (nz not a multiple of 128):
    the JAX masked sweep, one cell beyond the last tile, and a grid smaller
    than one tile."""
    from algebraicmultigrid_tpu.models.device import _apply_smoother, _build_smoother_cache
    from algebraicmultigrid_tpu.ops.lattice_nd_op import latnd_from_spec
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.kernels.sweep3d import smooth_sweep3d as smooth_t

    prob = amg.poisson(dims, lattice=True)
    A_j = latnd_from_spec(prob.spec, jnp.float32)
    masked = _build_smoother_cache(amg.GaussSeidel(ordering="multicolor"), prob, A_j, np.float32)
    assert type(masked).__name__ == "MaskedMulticolorCache"
    n = int(np.prod(dims))
    x, b = _vectors(n, A_j.rows_padded, seed=1)
    want = np.asarray(_apply_smoother(masked, A_j, jnp.asarray(x), jnp.asarray(b)))
    before = dict(vl.launches)
    got = smooth_t(_k7(dims, True, True), torch.as_tensor(x), torch.as_tensor(b)).numpy()
    assert vl.launches == before  # a CPU tensor runs the plain version
    assert got.shape == want.shape and rel_err(got[:n], want[:n]) < RTOL
    assert np.array_equal(got[n:], x[n:])


@pytest.mark.parametrize("fwd,bwd", [SYM] + FWD_BWD)
@pytest.mark.parametrize("stencil", ["5pt", "9pt"])
def test_k5_plain_matches_jax_kernel(stencil, fwd, bwd):
    """At 96² with ``tile_target=(64, 128)`` (two tiles), as
    tests/test_pallas_gs.py runs it, in interpret mode; the 9-point stencil
    has four colors."""
    from algebraicmultigrid_tpu.models.lattice import LatticeProblem as LP_j, lattice_coloring
    from algebraicmultigrid_tpu.ops.pallas.gs_kernel import build_pallas_gs_cache, smooth_pallas_gs
    from algebraicmultigrid_tpu_torch.models.lattice import LatticeProblem as LP_t
    from algebraicmultigrid_tpu_torch.ops.kernels.gs_sweep import build_gs_sweep_cache, smooth_gs
    from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec

    if stencil == "5pt":
        st = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], dtype=np.float64)
    else:
        st = -np.ones((3, 3))
        st[1, 1] = 8.0
    spec_j, spec_t = LP_j(st, (96, 96)).spec, LP_t(st, (96, 96)).spec
    grid, nc = lattice_coloring(spec_j)
    cache_j = build_pallas_gs_cache(
        spec_j, grid, nc, np.float32, 1.0, 1, fwd, bwd, interpret=True, fallback=None, tile_target=(64, 128)
    )
    A_t = lat2d_from_spec(spec_t, torch.float32, "cpu", row_pad=8)
    cache_t = build_gs_sweep_cache(A_t, _port_dinv(spec_t, A_t.rows_padded), grid, nc, 1.0, 1, fwd, bwd)
    _assert_k5_march(cache_t, A_t.row_dims)
    n = 96 * 96
    x, b = _vectors(n, A_t.rows_padded, seed=2)
    want = np.asarray(smooth_pallas_gs(cache_j, jnp.asarray(x), jnp.asarray(b)))
    got = smooth_gs(cache_t, torch.as_tensor(x), torch.as_tensor(b)).numpy()
    assert rel_err(got[:n], want[:n]) < RTOL


def test_k5_runs_only_where_no_legs_and_no_tail():
    """The symmetric hierarchy runs its legs and tail, so its levels keep
    the masked caches (for the W/F cycles); without legs and tail every
    Lat2D level runs K5, unless ``sweeps=False``."""
    from algebraicmultigrid_tpu_torch.models.device import MaskedMulticolorCache, build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels.gs_sweep import GSSweepCache

    _, ml_t = setup_both()
    kw = dict(device="cpu", dtype=torch.float32)
    h = build_device_hierarchy(ml_t, tail_max_rows=5000, **kw)
    assert h.tail_start == 1 and h.levels[0].fused is not None
    assert all(isinstance(c, MaskedMulticolorCache) for L in h.levels for c in (L.pre, L.post))
    h = build_device_hierarchy(ml_t, fused=False, tail=False, **kw)
    assert all(isinstance(c, GSSweepCache) and c.A is L.A for L in h.levels for c in (L.pre, L.post))
    h = build_device_hierarchy(ml_t, fused=False, tail=False, sweeps=False, **kw)
    assert all(isinstance(c, MaskedMulticolorCache) for L in h.levels for c in (L.pre, L.post))


def test_k5_shape_limit_keeps_masked_sweep(caplog):
    """A level whose halo leaves no tile within an SM's shared memory keeps
    the masked sweep, and the builder says why."""
    from algebraicmultigrid_tpu_torch.models.lattice import lattice_coloring
    from algebraicmultigrid_tpu_torch.ops.kernels.gs_sweep import build_gs_sweep_cache
    from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec

    st = np.zeros((9, 9))
    st[4, :] = st[:, 4] = -1.0
    st[4, 4] = 16.0
    spec = amt.LatticeProblem(st, (400, 400)).spec
    A = lat2d_from_spec(spec, torch.float64, "cpu", row_pad=8)
    grid, nc = lattice_coloring(spec)
    with caplog.at_level("INFO"):
        cache = build_gs_sweep_cache(A, _port_dinv(spec, A.rows_padded, torch.float64), grid, nc, 1.0, 3, True, True)
    assert cache is None and "keeps the masked sweep" in caplog.text


@pytest.fixture(scope="module")
def fwd_bwd_pair():
    kw = dict(SETUP_KW, presmoother=None, postsmoother=None)
    out = []
    for pkg in (amg, amt):
        kw["presmoother"] = pkg.GaussSeidel(ordering="multicolor", sweep=pkg.ForwardSweep())
        kw["postsmoother"] = pkg.GaussSeidel(ordering="multicolor", sweep=pkg.BackwardSweep())
        out.append(pkg.structured_smoothed_aggregation(
            pkg.poisson((192, 192), lattice=True), aggregate=pkg.StructuredAggregation(box=3), **kw
        ))
    return out


def test_fwd_bwd_hierarchy_runs_k5_and_matches_jax(fwd_bwd_pair):
    from algebraicmultigrid_tpu.models.device import _one_iteration as cycle_j, build_device_hierarchy as build_j
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration as cycle_t, build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels.gs_sweep import GSSweepCache
    from algebraicmultigrid_tpu_torch.ops.lattice_op import Lat2D

    ml_j, ml_t = fwd_bwd_pair
    h_t = build_device_hierarchy(ml_t, device="cpu", dtype=torch.float64)
    assert h_t.tail is None and all(L.fused is None for L in h_t.levels)
    lat = [L for L in h_t.levels if isinstance(L.A, Lat2D)]
    assert lat and all(isinstance(c, GSSweepCache) for L in lat for c in (L.pre, L.post))
    assert lat[0].pre.steps == (0, 1) and lat[0].post.steps == (1, 0)
    for L in lat:
        for c in (L.pre, L.post):
            _assert_k5_march(c, L.A.row_dims)
    h_j = build_j(ml_j, dtype=jnp.float64)
    b = np.zeros(h_j.fine_padded)
    b[: 192 * 192] = np.random.default_rng(3).standard_normal(192 * 192)
    want = np.asarray(cycle_j(h_j, amg.V(), jnp.zeros(b.shape[0]), jnp.asarray(b)))
    got = cycle_t(h_t, amt.V(), torch.zeros(b.shape[0], dtype=torch.float64), torch.as_tensor(b)).numpy()
    assert rel_err(got, want) < 1e-10
