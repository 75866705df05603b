"""The schedules of the march (K7, and K5 on a Lat2D level) and of the
split ``scan_gs`` recurrence, emulated in plain PyTorch / numpy on the
CPU, against the kernels' plain versions, and the plans that choose their
routes.

* The march: a plane-by-plane emulation (``csrc/sweep_march.cuh``):
  columns of the planned y-z box, segments of axis 0 with their end halos,
  x's ring with its planned depth (a plane's load lands before the steps of
  its time, as early as the kernel could land it; the coefficient planes,
  b and D⁻¹ read in place), the color steps a wavefront a reach behind each
  other in batches of planes, and each plane stored when it is final.  In
  float64 it is bitwise equal to ``tiled_sweep_reference``.  K5 runs it on
  a Wx × Wy level as the grid (Wx, 1, Wy): the box is a 1 × E2 strip of
  rows, the planes are rows.
* ``scan_gs``: the kernel's split recurrence (every row's not-yet-updated
  part summed at the start of a sweep, the other half on the chain) on
  ``split_scan_gs``'s layout, against ``smooth_scan_gs_reference``.
"""

import math

import numpy as np
import pytest
import torch

import algebraicmultigrid_tpu_torch as amt

SWEEP_CONFIGS = [(1, True, True, 1.0), (1, True, False, 1.0), (1, False, True, 1.0), (2, True, True, 1.3)]
# (dims, planes a segment owns): segments cut short so inner ends occur
MARCH_CASES = [((5, 3, 4), 2), ((13, 9, 100), 5), ((45, 45, 45), 16)]


def _k7(dims, dtype, it, fwd, bwd, omega):
    from algebraicmultigrid_tpu_torch.models.lattice_nd import lattice_coloring_nd
    from algebraicmultigrid_tpu_torch.ops.kernels.sweep3d import build_sweep3d_cache
    from algebraicmultigrid_tpu_torch.ops.lattice_nd_op import latnd_from_spec

    prob = amt.poisson(dims, lattice=True)
    A = latnd_from_spec(prob.spec, dtype, "cpu")
    tab, nc = lattice_coloring_nd(prob.spec)
    dinv = torch.zeros(A.rows_padded, dtype=dtype)
    dinv[: A.shape[0]] = torch.as_tensor(1.0 / prob.spec.diagonal(), dtype=dtype)
    return build_sweep3d_cache(A, dinv, tab, nc, omega, it, fwd, bwd)


def _k5(kind, dims, dtype, it, fwd, bwd, omega):
    """K5's cache of a 5-point Poisson or 9-point (8, −1) level."""
    from algebraicmultigrid_tpu_torch.models.lattice import lattice_coloring
    from algebraicmultigrid_tpu_torch.ops.kernels.gs_sweep import build_gs_sweep_cache
    from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec

    if kind == "5pt":
        prob = amt.poisson(dims, lattice=True)
    else:
        st = -np.ones((3, 3))
        st[1, 1] = 8.0
        prob = amt.LatticeProblem(st, dims)
    A = lat2d_from_spec(prob.spec, dtype, "cpu", row_pad=8)
    grid, nc = lattice_coloring(prob.spec)
    dinv = torch.zeros(A.rows_padded, dtype=dtype)
    dinv[: A.shape[0]] = torch.as_tensor(1.0 / prob.spec.diagonal(), dtype=dtype)
    return build_gs_sweep_cache(A, dinv, grid, nc, omega, it, fwd, bwd)


def _xb(c, seed):
    n = math.prod(c.dims)
    rng = np.random.default_rng(seed)
    x = torch.zeros(c.A.rows_padded, dtype=torch.float64)
    b = torch.zeros_like(x)
    x[:n], b[:n] = torch.as_tensor(rng.standard_normal(n)), torch.as_tensor(rng.standard_normal(n))
    return x, b


def march_emulation(cache, x, b, plan, batch, ring=None):
    """The march on ``plan`` (a MarchPlan) in batches of ``batch`` planes
    with x's ring ``ring`` planes deep (default: the kernel's ring for that
    batch), in plain PyTorch."""
    from algebraicmultigrid_tpu_torch.ops.kernels.tiled_sweep import MARCH_DEPTH, _color_field, march_ring

    dims = n0, n1, n2 = cache.dims
    n = math.prod(dims)
    X, B, D = x[:n].reshape(dims), b[:n].reshape(dims), cache.dinv[:n].reshape(dims)
    P = cache.A.data.reshape((-1,) + dims)
    col = _color_field(cache, x.device)
    steps, S = cache.steps, len(cache.steps)
    r = [max(abs(d[a]) for d in cache.offsets) for a in range(3)]
    H = [S * v for v in r]
    E1, E2 = plan.box
    RX = march_ring(S, r[0], batch) if ring is None else ring
    out = X.clone()
    for o1 in range(-H[1], n1 - H[1], E1 - 2 * H[1]):
        for o2 in range(-H[2], n2 - H[2], E2 - 2 * H[2]):
            # the column's box on axes 1/2 inside the grid
            j0, j1, k0, k1 = max(o1, 0), min(o1 + E1, n1), max(o2, 0), min(o2 + E2, n2)
            box = (slice(j0 - o1, j1 - o1), slice(k0 - o2, k1 - o2))
            for a in range(0, n0, plan.seg):
                bend = min(a + plan.seg, n0)
                L, U = a - H[0], bend + H[0]
                xr = torch.zeros((RX, E1, E2), dtype=x.dtype)

                def boxed(arr, m, outside=0):
                    """Plane m of grid array arr over the box, as the
                    kernel reads it in place (``outside`` off the grid)."""
                    v = torch.full((E1, E2), outside, dtype=arr.dtype)
                    if 0 <= m < n0:
                        v[box] = arr[m, j0:j1, k0:k1]
                    return v

                def load(m):
                    xr[(m - L) % RX] = boxed(X, m)

                nb, depth = batch, MARCH_DEPTH
                for m in range(L, min(L + depth * nb, U)):
                    load(m)
                for m0 in range(L, U, nb):
                    M = m0 + nb - 1
                    for m in range(m0 + depth * nb, min(m0 + (depth + 1) * nb, U)):
                        load(m)
                    for s, c in enumerate(steps):
                        l1, l2 = (s + 1) * r[1], (s + 1) * r[2]
                        reg = (slice(l1, E1 - l1), slice(l2, E2 - l2))
                        # the window's planes from one snapshot: the kernel
                        # updates them at once
                        new = []
                        for pl in range(M - (s + 1) * r[0] - nb + 1, M - (s + 1) * r[0] + 1):
                            if not (L + (s + 1) * r[0] <= pl < U - (s + 1) * r[0] and 0 <= pl < n0):
                                continue
                            acc = None
                            for k, (d0, d1, d2) in enumerate(cache.offsets):
                                g = xr[(pl + d0 - L) % RX][l1 + d1 : E1 - l1 + d1, l2 + d2 : E2 - l2 + d2]
                                term = boxed(P[k], pl)[reg] * g
                                acc = term if acc is None else acc + term
                            xs = xr[(pl - L) % RX]
                            dd, bb = boxed(D, pl)[reg], boxed(B, pl)[reg]
                            upd = xs[reg] + cache.omega * dd * (bb - acc)
                            new.append((xs, torch.where(boxed(col, pl, -1)[reg] == c, upd, xs[reg])))
                        for xs, v in new:
                            xs[reg] = v
                    for q in range(max(M - S * r[0] - nb + 1, a), min(M - S * r[0] + 1, bend)):
                        t1, t2 = max(o1 + H[1], 0), max(o2 + H[2], 0)
                        u1, u2 = min(o1 + E1 - H[1], n1), min(o2 + E2 - H[2], n2)
                        out[q, t1:u1, t2:u2] = xr[(q - L) % RX][t1 - o1 : u1 - o1, t2 - o2 : u2 - o2]
    res = x.clone()
    res[:n] = out.reshape(n)
    return res


# batches of 1 and 3 planes, and the kernel's
@pytest.mark.parametrize("batch", [1, 3, 4])
@pytest.mark.parametrize("config", SWEEP_CONFIGS, ids=str)
@pytest.mark.parametrize("dims,seg", MARCH_CASES, ids=str)
def test_march_schedule_is_the_step_by_step_sweep(dims, seg, config, batch, monkeypatch):
    """Bitwise in float64, on boxes planned as for float32 (the shared-memory
    limit lifted, so every configuration has a march plan)."""
    from algebraicmultigrid_tpu_torch.ops.kernels import tiled_sweep as ts

    c = _k7(dims, torch.float64, *config)
    monkeypatch.setattr(ts, "SMEM_LIMIT", 1 << 40)
    plan, why = ts.plan_march(c.dims, c.offsets, len(c.steps), 4, seg=seg)
    assert why is None and plan.seg <= seg < dims[0] and plan.box[0] - 2 * len(c.steps) >= 1
    rng = np.random.default_rng(sum(dims))
    n = math.prod(dims)
    x = torch.zeros(c.A.rows_padded, dtype=torch.float64)
    b = torch.zeros_like(x)
    x[:n], b[:n] = torch.as_tensor(rng.standard_normal(n)), torch.as_tensor(rng.standard_normal(n))
    want = ts.tiled_sweep_reference(c, x, b)
    assert torch.equal(march_emulation(c, x, b, plan, batch), want)
    assert not torch.equal(want, x)


@pytest.mark.parametrize("batch", [1, 3])
def test_march_emulation_sees_a_ring_one_plane_short(batch):
    """The emulation is sharp: an x ring one plane shorter than the planes a
    time reads overwrites one a step still reads.  (The kernel's ring holds
    batch - reach more: there a time's stores and the next time's loads run
    at once; the emulation stores before it loads.)"""
    from algebraicmultigrid_tpu_torch.ops.kernels import tiled_sweep as ts

    c = _k7((40, 9, 20), torch.float64, 1, True, True, 1.0)
    plan, _ = ts.plan_march(c.dims, c.offsets, len(c.steps), 4, seg=20)
    x = torch.zeros(c.A.rows_padded, dtype=torch.float64)
    x[: 40 * 9 * 20] = torch.as_tensor(np.random.default_rng(0).standard_normal(40 * 9 * 20))
    b = torch.ones_like(x)
    want = ts.tiled_sweep_reference(c, x, b)
    least = ts.march_ring(len(c.steps), 1, batch) - max(batch - 1, 0)
    assert torch.equal(march_emulation(c, x, b, plan, batch, ring=least), want)
    assert not torch.equal(march_emulation(c, x, b, plan, batch, ring=least - 1), want)


OFF7 = ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0))


def test_march_plan_routes_and_refusals(caplog):
    from algebraicmultigrid_tpu_torch.ops.kernels import tiled_sweep as ts

    # L0 of 256³: the planned box and ring fit one SM's shared memory; the
    # segments fill whole waves of blocks
    plan, why = ts.plan_march((256,) * 3, OFF7, 3, 4)
    nb = ts.MARCH_BATCH
    ring = 4 + nb + ts.MARCH_DEPTH * nb + max(nb - 1, 0)
    assert why is None and plan.box == ts.MARCH_BOX[4] and plan.ring == ring == ts.march_ring(3, 1)
    assert plan.smem == math.prod(plan.box) * ring * 4 <= ts.SMEM_LIMIT
    columns = math.prod(-(-256 // (e - 6)) for e in plan.box)
    assert plan.seg == ts.march_segment(256, 3, columns, plan.smem, plan.box[0] * plan.box[1] // 2) < 256
    assert ts.card_shape("cpu") == ts.H100_SM
    plan64, why = ts.plan_march((256,) * 3, OFF7, 3, 8)
    assert why is None and plan64.smem <= ts.SMEM_LIMIT and plan64.box[0] - 6 >= ts.MIN_TILE
    # 8 steps (iter = 2 of a symmetric 2-color sweep plus one) still leave a tile
    plan, why = ts.plan_march((256,) * 3, OFF7, 8, 4)
    assert why is None and plan.box[0] - 16 >= ts.MIN_TILE
    plan, why = ts.plan_march((13, 9, 100), OFF7, 65, 4)
    assert plan is None and "65 color steps" in why
    # a reach of 3 on axes 1 and 2 with 12 steps: the least box's threads
    # pass the block's
    far = OFF7 + ((0, 3, 0), (0, 0, 3))
    plan, why = ts.plan_march((45, 45, 45), far, 12, 4)
    assert plan is None and "threads" in why
    # the cache holds the march plan; a level past it keeps the masked sweep
    with caplog.at_level("INFO"):
        for dims in ((5, 3, 4), (13, 9, 100), (45, 45, 45)):
            for it, fwd, bwd, omega in SWEEP_CONFIGS:
                c = _k7(dims, torch.float32, it, fwd, bwd, omega)
                assert c.box is None and c.march is not None and c.march.smem <= ts.SMEM_LIMIT
                assert c.march.box[0] <= dims[1] + 2 * c.halo[1]
    assert "keeps the masked sweep" not in caplog.text


@pytest.mark.parametrize("itemsize", [4, 8])
def test_march_takes_every_level_the_halo_tile_takes(itemsize):
    """For stencils of reach 1 on axis 0 and at most 2 on axes 1 and 2, at
    1 to 64 color steps, wherever K7's first design (the halo tile) has a
    box the march has a plan."""
    from algebraicmultigrid_tpu_torch.ops.kernels import tiled_sweep as ts

    taken = 0
    for r1 in (1, 2):
        for r2 in (1, 2):
            offs = OFF7 + ((0, r1, 0), (0, -r1, 0), (0, 0, r2), (0, 0, -r2))
            for dims in ((5, 3, 4), (13, 9, 100), (256, 256, 256)):
                for n_steps in range(1, 65):
                    if ts.plan_box(3, dims, offs, n_steps, itemsize)[0] is None:
                        continue
                    taken += 1
                    plan, why = ts.plan_march(dims, offs, n_steps, itemsize)
                    assert why is None, (r1, r2, dims, n_steps, why)
    assert taken > 100


# --------------------------------------------------------------------------
# K5: the march on a Lat2D level, the grid (Wx, 1, Wy)
# --------------------------------------------------------------------------

# (stencil, dims, rows a segment owns, the strip's tile): (3, 5) is one
# strip; the 9-point (31, 77) level (four colors) and 96² end in partial
# strips and segments
MARCH2D_CASES = [("5pt", (3, 5), 2, None), ("9pt", (31, 77), 20, 24), ("5pt", (96, 96), 32, 64)]


# batches of 1 and 3 rows, and the kernel's (2 on a 5-point level, 4 on a
# 9-point one)
@pytest.mark.parametrize("batch", [1, 3, "kernel"])
@pytest.mark.parametrize("config", SWEEP_CONFIGS, ids=str)
@pytest.mark.parametrize("kind,dims,seg,tile", MARCH2D_CASES, ids=str)
def test_march2d_schedule_is_the_step_by_step_sweep(kind, dims, seg, tile, config, batch):
    """K5's march, bitwise in float64, on strips planned as for float32."""
    from algebraicmultigrid_tpu_torch.ops.kernels import tiled_sweep as ts

    c = _k5(kind, dims, torch.float64, *config)
    assert c.dims[1] == 1 and c.march is not None and c.march.box[0] == 1 and c.box is None
    box = None if tile is None else (1, tile + 2 * c.halo[2])
    plan, why = ts.plan_march(c.dims, c.offsets, len(c.steps), 4, box=box, seg=seg)
    assert why is None and plan.seg <= seg and (tile is None or plan.box == box)
    assert tile is None or -(-c.dims[2] // tile) > 1 and -(-c.dims[0] // plan.seg) > 1
    assert plan.batch == {"5pt": 2, "9pt": 4}[kind]
    x, b = _xb(c, sum(dims))
    want = ts.tiled_sweep_reference(c, x, b)
    assert torch.equal(march_emulation(c, x, b, plan, plan.batch if batch == "kernel" else batch), want)
    assert not torch.equal(want, x)


@pytest.mark.parametrize("batch", [1, 3])
def test_march2d_emulation_sees_a_ring_one_row_short(batch):
    """On a Lat2D level too, an x ring one row shorter than the rows a time
    reads overwrites one a step still reads."""
    from algebraicmultigrid_tpu_torch.ops.kernels import tiled_sweep as ts

    c = _k5("5pt", (20, 40), torch.float64, 1, True, True, 1.0)
    plan, _ = ts.plan_march(c.dims, c.offsets, len(c.steps), 4, seg=20)
    x, b = _xb(c, 0)
    want = ts.tiled_sweep_reference(c, x, b)
    least = ts.march_ring(len(c.steps), 1, batch) - max(batch - 1, 0)
    assert torch.equal(march_emulation(c, x, b, plan, batch, ring=least), want)
    assert not torch.equal(march_emulation(c, x, b, plan, batch, ring=least - 1), want)


O5 = ((-1, 0, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1), (1, 0, 0))
O9 = tuple((dx, 0, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))
# the Lat2D levels of the 4096² fwd/bwd hierarchy: (side, offsets, color
# steps of a smoother application); L0 is 5-point with 2 colors, L1…L6
# 9-point with 4
FWD_BWD_LEVELS = [(4096, O5, 2)] + [(w, O9, 4) for w in (1366, 456, 152, 51, 17, 6)]


@pytest.mark.parametrize("itemsize", [4, 8])
def test_march2d_plans_of_the_fwd_bwd_hierarchy(itemsize):
    """Every Lat2D level of the 4096² fwd/bwd hierarchy gets a strip that
    cuts its width into whole columns of about ``MARCH_STRIP`` cells, a
    ring of its reach and steps in shared memory, and the segments of the
    planner's rule."""
    from algebraicmultigrid_tpu_torch.ops.kernels import tiled_sweep as ts

    for side, offs, S in FWD_BWD_LEVELS:
        plan, why = ts.plan_march((side, 1, side), offs, S, itemsize)
        assert why is None, (side, why)
        cols = -(-side // ts.MARCH_STRIP)
        tile = -(-side // cols)
        threads = -(-plan.box[1] // ts.MARCH_UNIT)
        assert plan.batch == ts.MARCH_BATCH_2D[len(offs)] == (2 if offs is O5 else 4)
        assert plan.box == (1, tile + 2 * S) and plan.ring == ts.march_ring(S, 1, plan.batch)
        assert plan.smem == plan.box[1] * plan.ring * itemsize <= ts.SMEM_LIMIT
        assert threads <= ts.MARCH_MAX_THREADS_2D < ts.MARCH_MAX_THREADS
        seg = ts.march_segment(side, S, cols, plan.smem, threads, batch=plan.batch)
        assert plan.seg == -(-side // -(-side // seg)) and plan.seg <= side
    # L0 in float32: eight whole columns of 512 cells, each strip 516 wide
    plan, _ = ts.plan_march((4096, 1, 4096), O5, 2, 4)
    assert ts.MARCH_STRIP == 512 and plan.box == (1, 516)
    # refusals: past 64 color steps; a least strip whose threads pass the
    # block's (reach 64 across the rows); a ring of a cross stencil of reach
    # 4 at 3 symmetric sweeps that no SM's shared memory holds
    plan, why = ts.plan_march((4096, 1, 4096), O5, 65, itemsize)
    assert plan is None and "65 color steps" in why
    plan, why = ts.plan_march((456, 1, 456), O5 + ((0, 0, 64), (0, 0, -64)), 16, itemsize)
    assert plan is None and "threads" in why
    cross = tuple((d, 0, 0) for d in range(-4, 5) if d) + tuple((0, 0, d) for d in range(-4, 5))
    plan, why = ts.plan_march((400, 1, 400), cross, 54, itemsize)
    assert plan is None and "shared memory" in why


@pytest.mark.parametrize("itemsize", [4, 8])
def test_march2d_takes_every_level_the_halo_tile_takes(itemsize):
    """For 2-D stencils of reach 1 or 2 on each axis, at 1 to 64 color
    steps, wherever K5's first design (the halo tile on the grid (1, Wx,
    Wy)) has a box the march has a plan on the grid (Wx, 1, Wy)."""
    from algebraicmultigrid_tpu_torch.ops.kernels import tiled_sweep as ts

    taken = 0
    for r0 in (1, 2):
        for r2 in (1, 2):
            offs = O5 + ((r0, 0, 0), (-r0, 0, 0), (0, 0, r2), (0, 0, -r2))
            tile_offs = tuple((0, d0, d2) for d0, _, d2 in offs)
            for wx, wy in ((3, 5), (31, 77), (4096, 4096)):
                for n_steps in range(1, 65):
                    if ts.plan_box(2, (1, wx, wy), tile_offs, n_steps, itemsize)[0] is None:
                        continue
                    taken += 1
                    plan, why = ts.plan_march((wx, 1, wy), offs, n_steps, itemsize)
                    assert why is None, (r0, r2, wx, wy, n_steps, why)
    assert taken > 100


# --------------------------------------------------------------------------
# scan_gs
# --------------------------------------------------------------------------


def split_emulation(cache, x, b):
    """The kernel's split recurrence in numpy float64 (its summation
    order): per sweep the not-yet-updated part of every row at once, then
    the chain over the other half."""
    sp = cache.split
    lo = (sp.lo_data.numpy(), sp.lo_cols.numpy().astype(np.int64))
    up = (sp.up_data.numpy(), sp.up_cols.numpy().astype(np.int64))
    d = cache.diag.numpy()
    ds = sp.dshift.numpy()
    x, b = x.numpy().copy(), b.numpy()
    al = np.where(d == 0, 1.0, 1.0 - cache.omega)
    be = np.where(d == 0, 0.0, cache.omega / np.where(d == 0, 1.0, d))
    rows = x.shape[0]
    for _ in range(cache.iter):
        for fwd in (True, False):
            if not (cache.forward if fwd else cache.backward):
                continue
            (pd, pc), (cd, cc) = (up, lo) if fwd else (lo, up)
            part = ds * x
            for k in range(pd.shape[0]):
                part = part + pd[k] * x[pc[k]]
            e = al * x + be * (b - part)
            cdl, ccl = cd.T.tolist(), cc.T.tolist()
            for i in range(rows) if fwd else range(rows - 1, -1, -1):
                s = 0.0
                for v, j in zip(cdl[i], ccl[i]):
                    s += v * x[j]
                x[i] = e[i] - be[i] * s
    return torch.as_tensor(x)


@pytest.fixture(scope="module", params=[48, 96])
def scan_levels(request):
    """The natural-order GS levels of scrambled n² Poisson (SA defaults),
    float64, on the CPU."""
    import scipy.sparse as sp

    from algebraicmultigrid_tpu_torch.models.device import ScanGSCache, build_device_hierarchy

    n = request.param
    A = sp.csr_matrix(amt.poisson((n, n)))
    p = np.random.default_rng(1).permutation(A.shape[0])
    ml = amt.smoothed_aggregation(A[p][:, p].tocsr())
    h = build_device_hierarchy(ml, device="cpu", dtype=torch.float64)
    levels = [L for L in h.levels if isinstance(L.pre, ScanGSCache)]
    assert levels
    return levels


@pytest.mark.parametrize("fwd,bwd", [(True, False), (False, True), (True, True)])
def test_split_scan_gs_matches_the_row_loop(scan_levels, fwd, bwd):
    import dataclasses

    from algebraicmultigrid_tpu_torch.ops.kernels.scan_gs import smooth_scan_gs_reference

    for i, L in enumerate(scan_levels):
        c = dataclasses.replace(L.pre, iter=2, forward=fwd, backward=bwd)
        rng = np.random.default_rng(i)
        n, pad = L.A.shape[0], L.A.rows_padded
        x, b = torch.zeros(pad, dtype=torch.float64), torch.zeros(pad, dtype=torch.float64)
        x[:n], b[:n] = torch.as_tensor(rng.standard_normal(n)), torch.as_tensor(rng.standard_normal(n))
        want = smooth_scan_gs_reference(L.A, c.diag, x, b, c.omega, c.iter, fwd, bwd)
        got = split_emulation(c, x, b)
        assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())


def test_split_scan_gs_layout_and_routes(scan_levels):
    """Each row's halves and dshift rebuild the ELL row; a level stages
    where its halves fit, and a 2048-row level with 20 slots a row streams."""
    from algebraicmultigrid_tpu_torch.ops.kernels.scan_gs import plan_scan_route, smem_bytes
    from algebraicmultigrid_tpu_torch.ops.kernels.vcycle_legs import SMEM_LIMIT

    routes = []
    for L in scan_levels:
        sp = L.pre.split
        rows = L.A.rows_padded
        assert sp.lo_cols.dtype == sp.up_cols.dtype == torch.int16
        routes.append(sp.route)
        staged = smem_bytes(rows, sp.lo_data.shape[0], sp.up_data.shape[0], 8, True) <= SMEM_LIMIT
        assert sp.route == ("staged" if staged else "streamed")
        dense = np.zeros((rows, rows))
        np.add.at(dense, (np.repeat(np.arange(rows), L.A.width), L.A.cols.numpy().ravel()), L.A.data.numpy().ravel())
        rebuilt = np.diag(sp.dshift.numpy() + L.pre.diag.numpy())
        for hd, hc, side in ((sp.lo_data, sp.lo_cols, np.less), (sp.up_data, sp.up_cols, np.greater)):
            hd, hc = hd.numpy(), hc.numpy().astype(np.int64)
            live = hd != 0
            assert side(hc[live], np.broadcast_to(np.arange(rows), hc.shape)[live]).all()
            np.add.at(rebuilt, (np.broadcast_to(np.arange(rows), hc.shape), hc), hd)
        assert np.array_equal(rebuilt, dense)
    assert "staged" in routes
    assert plan_scan_route(2048, 10, 10, 8) == (
        "streamed", f"the halves need {smem_bytes(2048, 10, 10, 8, True)} bytes of shared memory (limit {SMEM_LIMIT})"
    )
    assert plan_scan_route(2048, 10, 10, 4)[0] == "streamed" and plan_scan_route(376, 10, 10, 4) == ("staged", None)
    with pytest.raises(ValueError):
        plan_scan_route(40_000, 2, 2, 4)
