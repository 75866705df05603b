"""The non-factored R/P-plane branches of K1, K2 and K4 on the 192²
structured-SA problem set up with ``symmetry=NoSymmetry()`` (which stashes
no factored prolongator): the port's R and P planes bitwise equal to the
JAX builders' (the legs' in float32 and bf16, the whole tail's R at the
working dtype and P in bf16), the plain versions of K1, K2 and K4 against
the JAX interpret-mode kernels (float64 to relative 1e-10, float32 to
1e-5), the non-factored V-cycle against the factored one on the default
hierarchy (float64 to 1e-12: P = (I − diag(s)A)T holds exactly), the
fixed-cycle loop that takes no K3 on a non-factored top level, and the
caches K3 and K9 refuse.  The CUDA entries are held against these plain
versions on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import algebraicmultigrid_tpu_torch as amt
from torch_port_common import PLAIN_TILES, jax_env, jax_hierarchy_to_numpy, jax_tail_to_numpy, rel_err, setup_both

LEVELS = [0, 1, 2, 3]
BF16 = dict(AMG_COEF_DTYPE="bfloat16")
TOL = {torch.float32: 1e-5, torch.float64: 1e-10}
NP = {torch.float32: np.float32, torch.float64: np.float64}
JNP = {torch.float32: jnp.float32, torch.float64: jnp.float64}
TAIL_ROWS = "5000"  # tests/test_fused_tail.py's setting: the tail starts at L1


@pytest.fixture(scope="module")
def problem():
    """The NoSymmetry host hierarchies of both packages, the JAX device
    hierarchies (legs on every level in float32, float64 and with bf16
    planes; the whole tail from L1 in float64 and with bf16 planes) and the
    port's factored (default) host hierarchy."""
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j

    ml_j, ml_t = setup_both(nosym=True)
    legs, tails = {}, {}
    for dt in (torch.float32, torch.float64):
        with jax_env(**PLAIN_TILES):
            legs[dt] = build_j(ml_j, dtype=JNP[dt])
    with jax_env(**BF16, **PLAIN_TILES):
        legs["bf16"] = build_j(ml_j, dtype=jnp.float32)
    with jax_env(AMG_PALLAS_TAIL="1", AMG_TAIL_MAX_ROWS=TAIL_ROWS):
        tails[torch.float64] = build_j(ml_j, dtype=jnp.float64)
    with jax_env(**BF16, AMG_PALLAS_TAIL="1", AMG_TAIL_MAX_ROWS=TAIL_ROWS):
        tails["bf16"] = build_j(ml_j, dtype=jnp.float32)
    for h in legs.values():
        assert h.tail is None and all(L.fused is not None and not L.fused.factored for L in h.levels)
    for h in tails.values():
        assert h.tail_start == 1 and not any(m.factored for m in h.tail.metas)
    return ml_j, ml_t, legs, tails, setup_both()[1]


def _build(ml, dtype=torch.float64, **kw):
    return amt.build_device_hierarchy(ml, device="cpu", dtype=dtype, **kw)


def _vec(n, pad, seed, dtype=np.float64):
    v = np.zeros(pad, dtype)
    v[:n] = np.random.default_rng(seed).standard_normal(n)
    return v


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("planes", ["f32", "bf16"])
@pytest.mark.parametrize("lvl", LEVELS)
def test_leg_planes_equal_jax_bitwise(problem, lvl, planes):
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from torch_port_common import _fused

    _, ml_t, legs, _, _ = problem
    key, coef = (torch.float32, None) if planes == "f32" else ("bf16", torch.bfloat16)
    want = _fused(legs[key].levels[lvl].fused)
    f = _build(ml_t, torch.float32, tail=False, coef_dtype=coef).levels[lvl].fused
    assert not f.factored and f.T is None and f.S is None
    assert f.offsR == tuple(want["offsR"]) and f.offsP == tuple(want["offsP"])
    # K1's and K2's own tiles, no K3
    assert f.updown_tile is None and not f.up_pipelined
    assert f.down_tile == vl.plan_down_nf(f.row_dims, f.k, f.offsA, f.offsR, len(f.steps)) is not None
    assert f.up_tile == vl.plan_up_nf(f.row_dims, f.k, f.offsA, len(f.steps)) is not None
    for name in ("A", "dinv", "R", "P"):
        got = getattr(f, name)
        assert got.dtype == (coef or torch.float32)
        assert got.shape == np.asarray(want[name]).shape, name
        assert np.array_equal(_f32(got), _f32(want[name])), name


@pytest.mark.parametrize("planes", ["f64", "bf16"])
def test_tail_planes_equal_jax_bitwise(problem, planes):
    _, ml_t, _, tails, _ = problem
    key, dt, coef = (torch.float64, torch.float64, None) if planes == "f64" else ("bf16", torch.float32, torch.bfloat16)
    want = jax_tail_to_numpy(tails[key])
    h = _build(ml_t, dt, coef_dtype=coef, tail_max_rows=int(TAIL_ROWS))
    assert h.tail_start == 1 and len(h.tail.levels) == len(want["levels"]) and not h.tail.factored
    assert h.tail.tiles == ((0, 0),) * len(h.tail.levels)
    for L, d in zip(h.tail.levels, want["levels"]):
        assert (L.A.dtype, L.P.dtype, L.R.dtype, L.dinv.dtype) == ((coef or dt),) * 2 + (dt,) * 2
        assert L.offsR == tuple(d["offsR"]) and L.offsP == tuple(d["offsP"])
        for name in ("A", "dinv", "R", "P"):
            want_p = np.asarray(d[name])
            got = getattr(L, name)
            assert got.shape == want_p.shape, (L.row_dims, name)
            assert np.array_equal(got.to(dt).numpy(), want_p.astype(NP[dt])), (L.row_dims, name)


@pytest.fixture(scope="module")
def ragged():
    """The NoSymmetry problem at 200² (200 = 3·66 + 2: clipped coarse boxes
    at L0, a partial last tile under the non-factored plans) in both
    packages, with the JAX device hierarchies in float32 and float64."""
    from algebraicmultigrid_tpu.models.device import build_device_hierarchy as build_j

    ml_j, ml_t = setup_both(n=RAGGED_N, nosym=True)
    legs = {}
    for dt in (torch.float32, torch.float64):
        with jax_env(**PLAIN_TILES):
            legs[dt] = build_j(ml_j, dtype=JNP[dt])
    return ml_j, ml_t, legs


RAGGED_N = 200


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lvl", [0, 1, "ragged"])
def test_fused_down_up_match_jax_kernels(problem, lvl, dtype, request):
    """One K1 call (from x and from zero) and one K2 call on the port's own
    caches and on the JAX caches carried across, against the JAX kernels;
    "ragged": L0 of the 200² problem, whose grid no tile of the
    non-factored plans divides."""
    from algebraicmultigrid_tpu.ops.pallas.vcycle_kernels import fused_down as down_j, fused_up as up_j
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy
    from algebraicmultigrid_tpu_torch.ops.kernels.vcycle_legs import fused_down_reference, fused_up_reference

    _, ml_t, legs, _, _ = problem
    if lvl == "ragged":
        _, ml_t, legs = request.getfixturevalue("ragged")
        lvl = 0
    h_j = legs[dtype]
    Lj = h_j.levels[lvl]
    n, pad, nc = Lj.A.shape[0], Lj.A.rows_padded, Lj.R.shape[0]
    own = _build(ml_t, dtype, tail=False).levels[lvl].fused
    conv = hierarchy_from_numpy(*jax_hierarchy_to_numpy(h_j), device="cpu", dtype=dtype).levels[lvl].fused
    assert own.down_tile is not None and own.up_tile is not None and own.row_dims == conv.row_dims
    npd = NP[dtype]
    x, b, xc = _vec(n, pad, lvl, npd), _vec(n, pad, 10 + lvl, npd), _vec(nc, nc, 20 + lvl, npd)
    for x_zero in (False, True):
        xin = np.zeros_like(x) if x_zero else x
        xj, bcj = down_j(Lj.fused, jnp.asarray(xin), jnp.asarray(b), x_zero=x_zero)
        for f in (own, conv):
            xt, bct = fused_down_reference(f, torch.as_tensor(xin), torch.as_tensor(b), x_zero=x_zero)
            assert xt.dtype == dtype and xt.shape == (pad,)
            assert rel_err(xt, xj) < TOL[dtype] and rel_err(bct, np.asarray(bcj)[:nc]) < TOL[dtype]
    uj = up_j(Lj.fused, jnp.asarray(x), jnp.asarray(b), jnp.asarray(xc), out_len=pad)
    for f in (own, conv):
        ut = fused_up_reference(f, torch.as_tensor(x), torch.as_tensor(b), torch.as_tensor(xc))
        assert rel_err(ut, uj) < TOL[dtype]


def test_restriction_and_correction_are_the_lattice_operators(problem):
    """The R/P-plane sums equal the level's own R·r and x + P·x_c (the
    host lattice operators), to float64 rounding."""
    from algebraicmultigrid_tpu_torch.ops.kernels.vcycle_legs import correct_planes_reference, restrict_planes_reference

    _, ml_t, _, _, _ = problem
    h = _build(ml_t, tail=False)
    for lvl, level in enumerate(ml_t.levels):
        f = h.levels[lvl].fused
        Wx, Wy = f.row_dims
        r = np.random.default_rng(lvl).standard_normal(Wx * Wy)
        xc = np.random.default_rng(50 + lvl).standard_normal(level.P.shape[1])
        bc = restrict_planes_reference(f.R, f.offsR, torch.as_tensor(r.reshape(Wx, Wy)), f.k, f.col_dims)
        assert rel_err(bc.reshape(-1), level.R @ r) < 1e-14
        corr = correct_planes_reference(f.P, f.offsP, torch.as_tensor(xc.reshape(f.col_dims)), f.k, f.row_dims)
        assert rel_err(corr.reshape(-1), level.P @ xc) < 1e-14


@pytest.mark.parametrize("x_zero", [True, False])
def test_fused_tail_matches_jax_kernel(problem, x_zero):
    """The port's K4 plain version on its own non-factored tail and on the
    JAX one carried across, against JAX ``fused_tail`` in float64."""
    from algebraicmultigrid_tpu.ops.pallas.tail_kernel import fused_tail as tail_j
    from algebraicmultigrid_tpu_torch.convert import hierarchy_from_numpy
    from algebraicmultigrid_tpu_torch.ops.kernels.tail_kernel import fused_tail_reference

    _, ml_t, _, tails, _ = problem
    h_j = tails[torch.float64]
    levels, coarse = jax_hierarchy_to_numpy(h_j)
    conv = hierarchy_from_numpy(
        levels, coarse, device="cpu", dtype=torch.float64, tail=jax_tail_to_numpy(h_j), tail_start=1,
    )
    own = _build(ml_t, tail_max_rows=int(TAIL_ROWS))
    L1 = h_j.levels[1].A
    n, pad = L1.shape[0], L1.rows_padded
    x = np.zeros(pad) if x_zero else _vec(n, pad, 1)
    b = _vec(n, pad, 2)
    y_j = np.asarray(tail_j(h_j.tail, jnp.asarray(x), jnp.asarray(b), x_zero=x_zero))
    for h in (conv, own):
        assert h.tail_start == 1 and not h.tail.factored
        y = fused_tail_reference(h.tail, torch.as_tensor(x), torch.as_tensor(b), x_zero=x_zero)
        assert rel_err(y, y_j) < TOL[torch.float64]


def test_fused_tail_bf16_matches_jax_kernel(problem):
    """K4 with bf16 planes (A, P bf16; R and D⁻¹ float32) in float32."""
    from algebraicmultigrid_tpu.ops.pallas.tail_kernel import fused_tail as tail_j
    from algebraicmultigrid_tpu_torch.ops.kernels.tail_kernel import fused_tail_reference

    _, ml_t, _, tails, _ = problem
    h_j = tails["bf16"]
    own = _build(ml_t, torch.float32, coef_dtype=torch.bfloat16, tail_max_rows=int(TAIL_ROWS))
    L1 = h_j.levels[1].A
    n, pad = L1.shape[0], L1.rows_padded
    x, b = _vec(n, pad, 3, np.float32), _vec(n, pad, 4, np.float32)
    y_j = np.asarray(tail_j(h_j.tail, jnp.asarray(x), jnp.asarray(b)))
    y = fused_tail_reference(own.tail, torch.as_tensor(x), torch.as_tensor(b))
    assert rel_err(y, y_j) < TOL[torch.float32]


@pytest.mark.parametrize("tail", [False, True])
def test_nonfactored_vcycle_matches_factored(problem, tail):
    """On the default problem, a V-cycle through the R/P planes equals the
    factored one (float64, 1e-12): the same P and R, two ways."""
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration

    _, ml_n, _, _, ml_f = problem
    kw = dict(tail_max_rows=5000) if tail else dict(tail=False)
    h_n, h_f = _build(ml_n, **kw), _build(ml_f, **kw)
    assert h_n.tail_start == h_f.tail_start == (1 if tail else -1)
    assert not h_n.levels[0].fused.factored and h_f.levels[0].fused.factored
    pad = h_n.levels[0].A.rows_padded
    b = torch.as_tensor(_vec(ml_n.levels[0].A.shape[0], pad, 7))
    x = torch.as_tensor(_vec(ml_n.levels[0].A.shape[0], pad, 8))
    for x0 in (torch.zeros_like(b), x):
        y_n = _one_iteration(h_n, amt.V(), x0, b)
        y_f = _one_iteration(h_f, amt.V(), x0, b)
        assert rel_err(y_n, y_f) < 1e-12


def test_fixed_cycles_take_no_updown_on_a_nonfactored_top(problem, monkeypatch):
    """``run_fixed_cycles`` on a non-factored top level iterates the V-cycle
    (the JAX gate: K3 takes factored caches only) and never calls
    ``fused_updown``, which refuses such a cache."""
    from algebraicmultigrid_tpu_torch.models import device as dev
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    _, ml_n, _, _, _ = problem
    h = _build(ml_n, tail_max_rows=5000)
    f = h.levels[0].fused
    pad = h.levels[0].A.rows_padded
    b = torch.as_tensor(_vec(ml_n.levels[0].A.shape[0], pad, 9))
    want = torch.zeros_like(b)
    for _ in range(3):
        want = dev._one_iteration(h, amt.V(), want, b)

    def refuse(*a, **k):
        raise AssertionError("fused_updown was called on a non-factored top level")

    monkeypatch.setattr(dev, "fused_updown", refuse)
    got = dev.run_fixed_cycles(h, torch.zeros_like(b), b, 3)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="factored"):
        vl.fused_updown(f, b, b, torch.zeros(f.col_dims[0] * f.col_dims[1], dtype=b.dtype))
    with pytest.raises(ValueError, match="factored"):
        vl.fused_updown_reference(f, b, b, torch.zeros(f.col_dims[0] * f.col_dims[1], dtype=b.dtype))


def test_subcycle_refuses_nonfactored_levels(problem):
    """K9 takes factored levels only, as the JAX builder does."""
    from algebraicmultigrid_tpu_torch.ops.kernels.subcycle_kernel import build_fused_subcycle_cache

    _, ml_n, _, _, ml_f = problem
    assert build_fused_subcycle_cache(ml_n.levels, ml_n, 1, torch.float64, "cpu") is None
    h = _build(ml_n, tail_max_rows=600, subcycle=True)
    assert h.sub is None and h.tail_start == 2
    assert _build(ml_f, tail_max_rows=600, subcycle=True).sub is not None


def test_cpu_wrappers_take_the_plain_version(problem):
    from algebraicmultigrid_tpu_torch.ops.kernels import tail_kernel as tk
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    _, ml_n, _, _, _ = problem
    h = _build(ml_n, tail_max_rows=5000)
    f = h.levels[0].fused
    pad = h.levels[0].A.rows_padded
    x, b = (torch.as_tensor(_vec(ml_n.levels[0].A.shape[0], pad, s)) for s in (11, 12))
    before = dict(vl.launches)
    xd, bc = vl.fused_down(f, x, b)
    xr, bcr = vl.fused_down_reference(f, x, b)
    assert torch.equal(xd, xr) and torch.equal(bc, bcr)
    assert torch.equal(vl.fused_up(f, xd, b, bc), vl.fused_up_reference(f, xd, b, bc))
    bt = torch.as_tensor(_vec(bc.shape[0], h.levels[1].A.rows_padded, 13))
    assert torch.equal(tk.fused_tail(h.tail, bt, bt), tk.fused_tail_reference(h.tail, bt, bt))
    assert vl.launches == before
    assert vl.plane_suffix(f, "fused_down") == "f64"
    assert vl.plane_suffix(h.tail.levels[0], "fused_tail", dinv_working=True) == "f64"
    bf = vl.round_planes(f, torch.bfloat16, dtype=torch.float64)
    assert vl.plane_suffix(bf, "fused_down") == "f64_bf16"
    with pytest.raises(TypeError, match="R"):
        vl.plane_suffix(bf, "fused_tail", dinv_working=True)
