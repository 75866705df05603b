"""Multi-RHS (``x[n, k]``) cycles of the port on lattice hierarchies against
the JAX package's ``_one_iteration`` with the same 2-D x, float64 to 1e-10:
a hierarchy with legs and a whole-tail cache (the block runs past both, as
in the JAX package), one whose Lat2D levels run K5 and one whose 3-D fine
level runs K7 (the whole-sweep caches hand the block to their masked
fallback).  The drivers, formats and ELL smoothers are in
``test_torch_multi_rhs.py``."""

import algebraicmultigrid_tpu as amg
import algebraicmultigrid_tpu_torch as amt

from torch_port_common import K, SETUP_KW, multi_rhs_cycles as _cycle_pair, rel_err


def test_cycle_multi_rhs_bypasses_legs_and_tail():
    ml_j, ml_t = (
        pkg.structured_smoothed_aggregation(
            pkg.poisson((192, 192), lattice=True), aggregate=pkg.StructuredAggregation(box=3), **SETUP_KW
        )
        for pkg in (amg, amt)
    )
    h_t, got, want = _cycle_pair(ml_j, ml_t, 192 * 192, 2, tail_max_rows=5000)
    assert h_t.levels[0].fused is not None and h_t.tail is not None
    assert got.shape == want.shape == (h_t.fine_padded, K)
    assert rel_err(got, want) < 1e-10


def test_cycle_multi_rhs_k5_fallback_matches_jax():
    from algebraicmultigrid_tpu_torch.models.device import MaskedMulticolorCache
    from algebraicmultigrid_tpu_torch.ops.kernels.gs_sweep import GSSweepCache

    pair = []
    for pkg in (amg, amt):
        kw = dict(SETUP_KW, presmoother=pkg.GaussSeidel(ordering="multicolor", sweep=pkg.ForwardSweep()),
                  postsmoother=pkg.GaussSeidel(ordering="multicolor", sweep=pkg.BackwardSweep()))
        pair.append(pkg.structured_smoothed_aggregation(
            pkg.poisson((192, 192), lattice=True), aggregate=pkg.StructuredAggregation(box=3), **kw
        ))
    h_t, got, want = _cycle_pair(*pair, 192 * 192, 3)
    pre = h_t.levels[0].pre
    assert isinstance(pre, GSSweepCache) and isinstance(pre.fallback, MaskedMulticolorCache)
    assert rel_err(got, want) < 1e-10


def test_cycle_multi_rhs_k7_fallback_matches_jax():
    from algebraicmultigrid_tpu_torch.models.device import MaskedMulticolorCache
    from algebraicmultigrid_tpu_torch.ops.kernels.sweep3d import Sweep3DCache

    kw = dict(proxy=12, cut_rows=2000, min_proxy_dim=9)
    ml_j, ml_t = (pkg.structured_smoothed_aggregation_nd(pkg.poisson((45,) * 3, lattice=True), **kw)
                  for pkg in (amg, amt))
    h_t, got, want = _cycle_pair(ml_j, ml_t, 45 ** 3, 4)
    pre = h_t.levels[0].pre
    assert isinstance(pre, Sweep3DCache) and isinstance(pre.fallback, MaskedMulticolorCache)
    assert rel_err(got, want) < 1e-10


