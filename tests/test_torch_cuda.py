"""The port on a CUDA card: the fused-leg, updown and whole-tail kernels
against their plain versions, and one cycle, the fixed-cycle loop and a
refined solve on the card against the CPU.

Every test here needs a card and skips without one.  This file imports no
JAX, so on a machine without JAX run it without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -m gpu
"""

import numpy as np
import pytest
import torch

N = 192
SETUP_KW = dict(proxy=64, cut_rows=2000, min_proxy_dim=16)
TOL = 1e-5

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def ml():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")
    import algebraicmultigrid_tpu_torch as amt

    return amt.structured_smoothed_aggregation(
        amt.poisson((N, N), lattice=True), aggregate=amt.StructuredAggregation(box=3), **SETUP_KW
    )


def _vec(n, pad, seed, dtype=torch.float32):
    v = torch.zeros(pad, dtype=dtype)
    v[:n] = torch.as_tensor(np.random.default_rng(seed).standard_normal(n), dtype=dtype)
    return v.cuda()


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_cuda_legs_match_plain_versions(ml, lvl, dtype):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    h = build_device_hierarchy(ml, device="cuda", dtype=dtype, tail=False)
    L = h.levels[lvl]
    n, pad, nc = L.A.shape[0], L.A.rows_padded, L.R.shape[0]
    x, b, xc = _vec(n, pad, 1, dtype), _vec(n, pad, 2, dtype), _vec(nc, nc, 3, dtype)
    tol = TOL if dtype == torch.float32 else 1e-12
    before = dict(vl.launches)
    for x_zero in (False, True):
        got = vl.fused_down(L.fused, x, b, x_zero=x_zero)
        ref = vl.fused_down_reference(L.fused, x, b, x_zero=x_zero)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert g.shape == r.shape and _rel(g, r) < tol
    got = vl.fused_up(L.fused, x, b, xc)
    assert _rel(got, vl.fused_up_reference(L.fused, x, b, xc)) < tol
    assert vl.launches["down"] == before["down"] + 2
    assert vl.launches["up"] == before["up"] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lvl", [0, 1])
def test_cuda_updown_matches_plain_version(ml, lvl, dtype):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    L = build_device_hierarchy(ml, device="cuda", dtype=dtype, tail=False).levels[lvl]
    n, pad, nc = L.A.shape[0], L.A.rows_padded, L.R.shape[0]
    x, b, xc = _vec(n, pad, 1, dtype), _vec(n, pad, 2, dtype), _vec(nc, nc, 3, dtype)
    tol = TOL if dtype == torch.float32 else 1e-12
    before = vl.launches["updown"]
    got = vl.fused_updown(L.fused, x, b, xc)
    ref = vl.fused_updown_reference(L.fused, x, b, xc)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _rel(g, r) < tol
    assert vl.launches["updown"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows", [5000, 250_000])
def test_cuda_tail_matches_plain_version(ml, rows, dtype):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl
    from algebraicmultigrid_tpu_torch.ops.kernels.tail_kernel import fused_tail, fused_tail_reference

    h = build_device_hierarchy(ml, device="cuda", dtype=dtype, tail_max_rows=rows)
    assert h.tail is not None and h.tail_start == (1 if rows == 5000 else 0)
    L = h.levels[h.tail_start]
    n, pad = L.A.shape[0], L.A.rows_padded
    x, b = _vec(n, pad, 4, dtype), _vec(n, pad, 5, dtype)
    tol = TOL if dtype == torch.float32 else 1e-12
    before = vl.launches["tail"]
    for x_zero in (False, True):
        got = fused_tail(h.tail, x, b, x_zero=x_zero)
        ref = fused_tail_reference(h.tail, x, b, x_zero=x_zero)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and _rel(got, ref) < tol
    assert vl.launches["tail"] == before + 2


def test_cuda_fixed_cycles_match_cpu(ml):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy, run_fixed_cycles
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    out, counts = {}, {}
    for dev in ("cuda", "cpu"):
        h = build_device_hierarchy(ml, device=dev, dtype=torch.float64, tail_max_rows=5000)
        b = _vec(N * N, h.fine_padded, 6, torch.float64).to(dev)
        before = dict(vl.launches)
        out[dev] = run_fixed_cycles(h, torch.zeros_like(b), b, 3)
        counts[dev] = {k: vl.launches[k] - before[k] for k in before}
    assert _rel(out["cuda"], out["cpu"]) < 1e-12
    assert counts["cuda"] == {"down": 1, "up": 1, "updown": 2, "tail": 3}
    assert not any(counts["cpu"].values())


def test_cuda_wrappers_check_their_inputs(ml):
    from algebraicmultigrid_tpu_torch.models.device import build_device_hierarchy
    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    L = build_device_hierarchy(ml, device="cuda", dtype=torch.float32, tail=False).levels[0]
    n, pad = L.A.shape[0], L.A.rows_padded
    x = _vec(n, pad, 1)
    with pytest.raises(TypeError):
        vl.fused_down(L.fused, x.double(), x.double())
    with pytest.raises(ValueError):
        vl.fused_down(L.fused, x[: n - 1], x)
    with pytest.raises(TypeError):
        vl.fused_updown(L.fused, x.double(), x.double(), x.double())


def test_cuda_cycle_matches_cpu_float64(ml):
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration, build_device_hierarchy

    out = {}
    for dev in ("cuda", "cpu"):
        h = build_device_hierarchy(ml, device=dev, dtype=torch.float64)
        b = _vec(N * N, h.fine_padded, 5, torch.float64).to(dev)
        out[dev] = _one_iteration(h, amt.W(), torch.zeros_like(b), b)
    assert _rel(out["cuda"], out["cpu"]) < 1e-12


def test_cuda_solve_refined(ml):
    import algebraicmultigrid_tpu_torch as amt

    b = np.random.default_rng(6).standard_normal(N * N)
    x_gpu, hist_gpu = amt.solve_refined(ml, b, tol=1e-8, device="cuda", log=True)
    x_cpu, hist_cpu = amt.solve_refined(ml, b, tol=1e-8, device="cpu", log=True)
    assert len(hist_gpu) == len(hist_cpu)
    A = ml.levels[0].A
    assert np.linalg.norm(b - A @ x_gpu) / np.linalg.norm(b) < 1e-8
