"""Shared inputs for the tests that hold the PyTorch port against the JAX
package: one small structured-SA Poisson problem set up by both packages,
the JAX fused-leg switch scoped to a block, and the JAX device hierarchy
(with its whole-tail cache, where it has one) read out as the numpy dicts
``convert.hierarchy_from_numpy`` takes."""

import contextlib
import os

import numpy as np

N = 192
SETUP_KW = dict(proxy=64, cut_rows=2000, min_proxy_dim=16)


def setup_both(n=N, box=3, nosym=False):
    """(JAX hierarchy, port hierarchy) of poisson((n, n)) with box-k SA;
    ``nosym``: with ``symmetry=NoSymmetry()``, which stashes no factored
    prolongator (the legs' and the tail's R/P-plane branches)."""
    import algebraicmultigrid_tpu as amg
    import algebraicmultigrid_tpu_torch as amt

    hier = lambda pkg: pkg.structured_smoothed_aggregation(
        pkg.poisson((n, n), lattice=True), aggregate=pkg.StructuredAggregation(box=box),
        **SETUP_KW, **(dict(symmetry=pkg.NoSymmetry()) if nosym else {}),
    )
    return hier(amg), hier(amt)


@contextlib.contextmanager
def jax_env(**env):
    """Set JAX package switches (e.g. AMG_PALLAS_FUSED) for a block and
    restore the environment after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# the stencils and periodic colorings of synthetic lattice levels
LEG_OFFSETS = {
    5: ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),
    9: tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)),
}
LEG_COLORS = {5: ((0, 1), (1, 0)), 9: ((0, 1), (2, 3))}


def synthetic_leg_cache(dims, k, n_off, seed, iters=1, dtype=None, device="cpu", coef_dtype=None):
    """A factored leg cache of a ``dims`` lattice level with box-k coarsening
    and random planes (the arithmetic, not the matrix, is under test), the
    stencil's periodic coloring and the K1–K3 tiles planned from the shapes;
    ``coef_dtype=torch.bfloat16`` rounds the planes (made at ``dtype``,
    float32) to bf16."""
    import torch

    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    rng = np.random.default_rng(seed)
    Wx, Wy = dims
    offs = LEG_OFFSETS[n_off]
    grid = LEG_COLORS[n_off]
    dtype = dtype or torch.float64

    def t(*shape):
        return torch.as_tensor(rng.uniform(0.1, 1.0, shape), dtype=dtype, device=device)

    scale = torch.as_tensor([4.0 if o == (0, 0) else -0.25 for o in offs], dtype=dtype, device=device)
    cache = vl.with_tile_plans(vl.FusedLegCache(
        A=(t(len(offs), Wx, Wy) * scale[:, None, None]).contiguous(), dinv=t(Wx, Wy), T=t(Wx, Wy),
        S=t(Wx, Wy) * 0.3, offsA=offs, color_grid=grid, n_colors=len({c for row in grid for c in row}), k=k,
        row_dims=tuple(dims), col_dims=(-(-Wx // k), -(-Wy // k)), omega=1.0, iter=iters, forward=True,
        backward=True,
    ))
    return cache if coef_dtype is None else vl.round_planes(cache, coef_dtype)


def nf_offsets(k, n_off, p_offsets):
    """(R offsets, P offsets) of a synthetic non-factored level: R the k × k
    box dilated by the stencil (21 and 25 at box 3, as the flagship's L0
    and L1), P the 5-point cross or the 3 × 3 box."""
    offs = LEG_OFFSETS[n_off]
    offsR = tuple(sorted({(a + dx, c + dy) for a in range(k) for c in range(k) for dx, dy in offs}))
    return offsR, LEG_OFFSETS[{"cross": 5, "box": 9}[p_offsets]]


def synthetic_nf_cache(dims, k, n_off, seed, p_offsets="cross", iters=1, dtype=None, device="cpu",
                       coef_dtype=None):
    """A non-factored leg cache (R and P planes, no T and S) of a ``dims``
    lattice level with random planes and the offsets of ``nf_offsets``,
    its K1/K2 tiles planned from the shapes: vectors and planes of
    ``dtype`` (default float64), or with ``coef_dtype=torch.bfloat16``
    planes made at float32 and rounded to bf16 under ``dtype`` vectors."""
    import dataclasses

    import torch

    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    dtype = dtype or torch.float64
    plane_dtype = dtype if coef_dtype is None else torch.float32
    f = synthetic_leg_cache(dims, k, n_off, seed, iters=iters, dtype=plane_dtype, device=device)
    rng = np.random.default_rng(seed + 1)
    offsR, offsP = nf_offsets(k, n_off, p_offsets)

    def t(*shape):
        return torch.as_tensor(rng.uniform(-1.0, 1.0, shape), dtype=f.A.dtype, device=device).contiguous()

    cache = vl.with_tile_plans(dataclasses.replace(
        f, T=None, S=None, R=t(len(offsR), *f.col_dims), P=t(len(offsP), *f.row_dims), offsR=offsR, offsP=offsP,
    ))
    return cache if coef_dtype is None else vl.round_planes(cache, coef_dtype, dtype=dtype)


# box emulation of the tiled legs (tests/test_torch_tiled_updown.py,
# tests/test_torch_tiled_nonfactored.py)


def boxed(X, ox, oy, E0, E1):
    """X[ox:ox+E0, oy:oy+E1] with zeros outside the grid."""
    import torch

    Wx, Wy = X.shape[-2:]
    out = torch.zeros(X.shape[:-2] + (E0, E1), dtype=X.dtype)
    i0, i1, j0, j1 = max(ox, 0), min(ox + E0, Wx), max(oy, 0), min(oy + E1, Wy)
    if i0 < i1 and j0 < j1:
        out[..., i0 - ox : i1 - ox, j0 - oy : j1 - oy] = X[..., i0:i1, j0:j1]
    return out


def inside(ox, oy, E0, E1, dims):
    import torch

    return boxed(torch.ones(dims, dtype=torch.bool), ox, oy, E0, E1)


def box_steps(c, X, ox, oy, B, steps):
    """The leg's color steps on a box: step s updates the cells of its color
    at least (s+1)·reach from the box's faces, in the grid."""
    import torch

    from algebraicmultigrid_tpu_torch.ops.kernels import vcycle_legs as vl

    E0, E1 = X.shape
    A, D, B = (boxed(v.to(X.dtype), ox, oy, E0, E1) for v in (c.A, c.dinv, B))
    col = boxed(vl._color_plane(c, "cpu"), ox, oy, E0, E1)
    ins = inside(ox, oy, E0, E1, c.row_dims)
    ii = torch.arange(E0)[:, None]
    jj = torch.arange(E1)[None, :]
    for s, color in enumerate(steps):
        lo = (s + 1) * c.reach
        region = (ii >= lo) & (ii < E0 - lo) & (jj >= lo) & (jj < E1 - lo)
        r = B - vl._stencil(A, X, c.offsA)
        X = torch.where((col == color) & region & ins, X + c.omega * D * r, X)
    return X


def stitch_vectors(c, seed, pad=7):
    """(x, b, x_c) for a leg cache: x and b at the level's length plus
    ``pad`` zeros, float64."""
    import torch

    rng = np.random.default_rng(seed)
    n = c.row_dims[0] * c.row_dims[1]
    nc = c.col_dims[0] * c.col_dims[1]
    x, b = (torch.as_tensor(np.concatenate([rng.standard_normal(n), np.zeros(pad)])) for _ in range(2))
    return x, b, torch.as_tensor(rng.standard_normal(nc))


# the JAX fused-leg caches in a layout that untiles to full planes:
# no packed sweeps, no representative-tile compaction
PLAIN_TILES = dict(AMG_PALLAS_FUSED="1", AMG_PACKED_SWEEP="0", AMG_TILE_COMPACT="0")


def scrambled_poisson(n, seed=1):
    """poisson((n, n)) as CSC with rows and columns in a random order."""
    import algebraicmultigrid_tpu as amg
    import scipy.sparse as sp

    A = sp.csr_matrix(amg.poisson((n, n)))
    p = np.random.default_rng(seed).permutation(A.shape[0])
    return A[p][:, p].tocsc()


_ML = {}


def both_unstructured(name):
    """(JAX hierarchy, port hierarchy, A) for a named problem, cached:
    ``"rs_randlap"``, ``"sa_elastic"`` (with its near-null space) or
    ``"sa<N>"``, SA on a scrambled N² Poisson."""
    import algebraicmultigrid_tpu as amg
    import algebraicmultigrid_tpu_torch as amt
    import scipy.sparse as sp
    from conftest import load_csc, load_npz

    if name not in _ML:
        if name == "rs_randlap":
            A = load_csc("randlap")
            _ML[name] = (amg.ruge_stuben(A), amt.ruge_stuben(A), A)
        elif name == "sa_elastic":
            z = load_npz("lin_elastic_2d")
            A = sp.csc_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))
            _ML[name] = (amg.smoothed_aggregation(A, B=z["B"]), amt.smoothed_aggregation(A, B=z["B"]), A)
        else:  # "sa<N>": SA on a scrambled N² Poisson
            A = scrambled_poisson(int(name[2:]))
            _ML[name] = (amg.smoothed_aggregation(A), amt.smoothed_aggregation(A), A)
    return _ML[name]


def rel_err(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _fields(obj):
    """A JAX dataclass's fields, arrays read out as numpy."""
    import dataclasses

    return {
        f.name: np.asarray(v) if hasattr(v, "shape") else v
        for f in dataclasses.fields(obj)
        for v in [getattr(obj, f.name)]
    }


def _op(A):
    """Operator dict of any JAX device format (no ``format`` key for Lat2D)."""
    name = type(A).__name__
    if name != "Lat2D":
        return dict(_fields(A), format=name)
    return dict(
        data=np.asarray(A.data), offsets=A.offsets, row_dims=A.row_dims,
        col_dims=A.col_dims, base_x=A.base_x, base_y=A.base_y, shape=A.shape,
        nnz=A.nnz, rows_padded=A.rows_padded,
    )


def _smoother(c, rows_padded=None):
    """Smoother dict of any JAX smoother cache (no ``kind`` key for the
    masked multicolor cache)."""
    name = type(c).__name__
    if name != "MaskedMulticolorCache":
        return dict(_fields(c), kind=name, rows_padded=rows_padded)
    return dict(
        color_of=np.asarray(c.color_of), dinv=np.asarray(c.dinv), n_colors=c.n_colors,
        omega=c.omega, iter=c.iter, forward=c.forward, backward=c.backward,
    )


def _untile(t, f):
    """[gx, gy, (n,) BX, BY] halo tiles → full [(n,) Wx, Wy] planes."""
    TX, TY = f.tile
    Hfx, Hly = f.Hf[0], f.Hly or f.Hf[1]
    gx, gy = f.grid
    Wx, Wy = f.row_dims
    a = np.asarray(t)[..., Hfx : Hfx + TX, Hly : Hly + TY]
    if a.ndim == 5:
        a = np.moveaxis(a, 2, 0)
    a = np.swapaxes(a, -3, -2)  # [..., gx, TX, gy, TY]
    a = a.reshape(a.shape[:-4] + (gx * TX, gy * TY))
    return a[..., :Wx, :Wy]


def _untile_coarse(t, f):
    """[gx, gy, n, TXc, TYc] coarse tiles (no halo) → full [n, Wxc, Wyc]."""
    TXc, TYc = f.tile[0] // f.k, f.tile[1] // f.k
    gx, gy = f.grid
    a = np.moveaxis(np.asarray(t), 2, 0)  # [n, gx, gy, TXc, TYc]
    a = np.swapaxes(a, -3, -2).reshape(a.shape[0], gx * TXc, gy * TYc)
    return a[:, : f.col_dims[0], : f.col_dims[1]]


def _fused(f):
    """A JAX leg cache as the port's leg dict: the factored T/S planes, or
    the non-factored R/P planes with their offsets."""
    if f is None:
        return None
    assert not f.packed and f.cA is None and not f.expand_in_kernel
    planes = (
        dict(T=_untile(f.T_tiled, f), S=_untile(f.S_tiled, f)) if f.factored
        else dict(R=_untile_coarse(f.R_tiled, f), P=_untile(f.P_tiled, f), offsR=f.offsR, offsP=f.offsP)
    )
    return dict(
        A=_untile(f.A_tiled, f), dinv=_untile(f.dinv_tiled, f), **planes,
        offsA=f.offsA, color_grid=f.color_grid, n_colors=f.n_colors, k=f.k,
        row_dims=f.row_dims, col_dims=f.col_dims, omega=f.omega, iter=f.iter,
        forward=f.forward, backward=f.backward,
    )


def jax_hierarchy_to_numpy(h):
    """(levels, coarse) dicts of a JAX DeviceHierarchy built under
    PLAIN_TILES (or with no fused legs)."""
    levels = [
        dict(
            A=_op(L.A), P=_op(L.P), R=_op(L.R),
            pre=_smoother(L.pre, L.A.rows_padded), post=_smoother(L.post, L.A.rows_padded),
            fused=_fused(L.fused),
        )
        for L in h.levels
    ]
    c = h.coarse
    coarse = dict(
        kind=c.kind, n=c.n, rows_padded=c.rows_padded,
        mat=np.asarray(c.mat), qr_q=np.asarray(c.qr_q), qr_r=np.asarray(c.qr_r),
    )
    return levels, coarse


def jax_basis_to_numpy(h):
    """The ``final_A``/``perm0``/``iperm0`` keywords of
    ``hierarchy_from_numpy`` for a JAX DeviceHierarchy."""
    return dict(
        final_A=_op(h.final_A),
        perm0=None if h.perm0 is None else np.asarray(h.perm0),
        iperm0=None if h.iperm0 is None else np.asarray(h.iperm0),
    )


def jax_tail_to_numpy(h):
    """The ``tail`` dict of a JAX DeviceHierarchy's whole-tail cache: planes
    (factored T/S, or non-factored R/P) with the kernel's halo stripped, step
    metadata from the levels' smoothers, and Mc read back from the coarse
    planes G."""
    from algebraicmultigrid_tpu.ops.coloring import color_steps
    from algebraicmultigrid_tpu.ops.pallas.tail_kernel import _H

    t = h.tail
    levels = []
    for i, m in enumerate(t.metas):
        sm = h.levels[h.tail_start + i].pre
        assert color_steps(sm.n_colors, sm.iter, sm.forward, sm.backward, sm.omega) == m.steps
        Wx, Wy = m.dims
        crop = (Ellipsis, slice(_H, _H + Wx), slice(_H, _H + Wy))
        ccrop = (Ellipsis, slice(_H, _H + m.cdims[0]), slice(_H, _H + m.cdims[1]))
        planes = (
            dict(T=np.asarray(t.Tp[i])[crop], S=np.asarray(t.Sp[i])[crop]) if m.factored
            else dict(R=np.asarray(t.Rp[i])[ccrop], P=np.asarray(t.Pp[i])[crop], offsR=m.offsR, offsP=m.offsP)
        )
        levels.append(dict(
            A=np.asarray(t.A[i])[crop], dinv=np.asarray(t.dinv[i])[crop], **planes,
            offsA=m.offsA, color_grid=m.color_grid, n_colors=sm.n_colors, k=m.k,
            row_dims=m.dims, col_dims=m.cdims, omega=m.omega, iter=sm.iter,
            forward=sm.forward, backward=sm.backward,
        ))
    W7x, W7y = t.dims7
    n7 = W7x * W7y
    G = np.asarray(t.G)[:, _H : _H + W7x, _H : _H + W7y]
    return dict(levels=levels, Mc=G.reshape(n7, n7).T)


def jax_sub_to_numpy(h):
    """The ``sub`` dict of a JAX DeviceHierarchy's whole-subcycle cache: the
    top level's factored-leg planes untiled from the slabs ``A1/d1/T1/S1``
    (each slab's interior rows, the lanes cut to the grid) and the step
    metadata from the level's smoother; its deeper levels are the tail."""
    from algebraicmultigrid_tpu.ops.coloring import color_steps

    s = h.sub
    Wx, Wy = s.dims

    def untile(t):  # [g1, (n,) B1x, By1] → [(n,) Wx, Wy]
        a = np.asarray(t)[..., s.H1 : s.H1 + s.TX1, :Wy]
        if a.ndim == 4:
            a = np.moveaxis(a, 1, 0)
        return a.reshape(a.shape[:-3] + (s.g1 * s.TX1, Wy))[..., :Wx, :]

    sm = h.levels[h.sub_start].pre
    assert color_steps(sm.n_colors, sm.iter, sm.forward, sm.backward, sm.omega) == s.steps
    return dict(
        A=untile(s.A1), dinv=untile(s.d1), T=untile(s.T1), S=untile(s.S1),
        offsA=s.offsA, color_grid=s.color_grid, n_colors=sm.n_colors, k=s.k,
        row_dims=s.dims, col_dims=s.cdims, omega=s.omega, iter=sm.iter,
        forward=sm.forward, backward=sm.backward,
    )


# --------------------------------------------------------------------------
# the slab-sharded tier: what one rank computes (run in-process for n_sh = 1
# and on spawned gloo ranks through ``parallel.run_ranks`` for more)
# --------------------------------------------------------------------------

SLAB_N = 216  # tests/test_sharded_lattice.py's grid and setup
SLAB_KW = dict(proxy=72, cut_rows=2000, min_proxy_dim=16)
SLAB_DTYPES = ("float32", "float64")
SLAB_CYCLES = ("v", "w", "f")


def slab_problem(pkg, smoothers=False):
    """The 216² structured-SA hierarchy of ``pkg`` (the JAX package or the
    port); ``smoothers``: Jacobi pre, backward multicolor SOR post."""
    kw = dict(SLAB_KW, aggregate=pkg.StructuredAggregation(box=3))
    if smoothers:
        kw.update(presmoother=pkg.Jacobi(0.6, iter=2),
                  postsmoother=pkg.SOR(1.1, pkg.BackwardSweep(), ordering="multicolor"))
    return pkg.structured_smoothed_aggregation(pkg.poisson((SLAB_N, SLAB_N), lattice=True), **kw)


def slab_rhs(pdims, seed):
    """A standard-normal right-hand side on the true grid, zero on the
    padding, as the padded fine grid [Wxp, Wyp] (float64)."""
    b = np.zeros(pdims)
    b[:SLAB_N, :SLAB_N] = np.random.default_rng(seed).standard_normal((SLAB_N, SLAB_N))
    return b


def _rows_of(grid, h, mesh):
    """This rank's rows of a padded fine grid."""
    if not (h.levels[0].sharded and mesh.n_sh > 1):
        return grid
    loc = h.fine_pdims[0] // mesh.n_sh
    return grid[mesh.rank * loc : (mesh.rank + 1) * loc]


def slab_rank(mesh):
    """One rank's slabs of every slab-tier result the tests compare: the
    V/W/F cycles from zero and the fine matvec in float32 and float64, the
    Jacobi/SOR hierarchy's V-cycle, and ``solve_lattice_sharded`` (x, iters,
    relres) on b = A·1 to 1e-6."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.parallel import (
        build_slab_hierarchy,
        cycle_lattice_sharded,
        matvec_lattice_sharded,
        solve_lattice_sharded,
    )

    ml = slab_problem(amt)
    out = {}
    for dtype in SLAB_DTYPES:
        h = build_slab_hierarchy(ml, mesh.n_sh, dtype=dtype).to_rank(mesh.rank, mesh.device)
        b = torch.as_tensor(_rows_of(slab_rhs(h.fine_pdims, 1), h, mesh), device=mesh.device).to(getattr(torch, dtype))
        for cyc in SLAB_CYCLES:
            out[dtype, cyc] = cycle_lattice_sharded(h, torch.zeros_like(b), b, mesh, cyc).cpu().numpy()
        out[dtype, "matvec"] = matvec_lattice_sharded(h, b, mesh).cpu().numpy()
    h2 = build_slab_hierarchy(slab_problem(amt, smoothers=True), mesh.n_sh).to_rank(mesh.rank, mesh.device)
    b2 = torch.as_tensor(_rows_of(slab_rhs(h2.fine_pdims, 3), h2, mesh), dtype=torch.float32, device=mesh.device)
    out["smoothers", "v"] = cycle_lattice_sharded(h2, torch.zeros_like(b2), b2, mesh).cpu().numpy()
    A = ml.levels[0].A
    out["solve"] = solve_lattice_sharded(ml, A @ np.ones(A.shape[0]), mesh=mesh, tol=1e-6, maxiter=40, log=True)
    return out


def halo_case(name, n_sh):
    """The LatticeSpec of a named square Lat2D operator: ``"p64"``/``"p128"``
    the 5-point Poisson grid, ``"sa9"`` the
    9-point coarse level L1 (64²) of the 192² structured-SA hierarchy,
    ``"thin"`` a 5-point grid of 2·n_sh × 77 (slabs of exactly 2·reach
    rows, a width that is no multiple of 32)."""
    import algebraicmultigrid_tpu_torch as amt

    if name == "sa9":
        ml = amt.structured_smoothed_aggregation(
            amt.poisson((N, N), lattice=True), aggregate=amt.StructuredAggregation(box=3), **SETUP_KW
        )
        spec = ml.levels[1].A.spec
    else:
        dims = {"p64": (64, 64), "p128": (128, 128), "thin": (77, 2 * n_sh)}[name]  # (ny, nx)
        spec = amt.poisson(dims, lattice=True).spec
    return spec


def halo_rank(mesh, names, dtypes=SLAB_DTYPES):
    """This rank's slab of y = A·x for each named case and dtype, through
    ``lat2d_spmv_halo`` with ``overlap=False`` and ``overlap=True``; x is
    standard normal from seed 0 over the whole grid."""
    import torch

    from algebraicmultigrid_tpu_torch.ops.lattice_op import lat2d_from_spec
    from algebraicmultigrid_tpu_torch.parallel import lat2d_spmv_halo, shard_slab

    out = {}
    for name in names:
        spec = halo_case(name, mesh.n_sh)
        Wx, Wy = spec.row_dims
        x = np.random.default_rng(0).standard_normal(Wx * Wy)
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            A = lat2d_from_spec(spec, dt, mesh.device, row_pad=8)
            xs = shard_slab(torch.as_tensor(x, dtype=dt), mesh, Wx, Wy)
            out[name, dtype] = tuple(
                lat2d_spmv_halo(A, xs, mesh, overlap=ov).cpu().numpy() for ov in (False, True)
            )
    return out


def failing_rank(mesh):
    """A rank function that fails on rank 1 (the launcher must report it)."""
    if mesh.rank == 1:
        raise ValueError("rank 1 gives up")
    return mesh.rank


# --------------------------------------------------------------------------
# multi-RHS blocks
# --------------------------------------------------------------------------

K = 2  # right-hand sides


def rhs_block(n, pad=0, seed=0, dtype=None):
    """[n + pad, K] torch block, standard normal on the first n rows
    (float64 unless ``dtype``)."""
    import torch

    X = np.zeros((n + pad, K))
    X[:n] = np.random.default_rng(seed).standard_normal((n, K))
    return torch.as_tensor(X, dtype=dtype or torch.float64)


def multi_rhs_cycles(ml_j, ml_t, n, seed, **build_kw):
    """(port hierarchy, port x, JAX x) of one V-cycle from zero on a block
    B [n, K], float64; ``build_kw`` go to the port's builder."""
    import jax.numpy as jnp
    import torch

    import algebraicmultigrid_tpu as amg
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu.models.device import _one_iteration as cycle_j, build_device_hierarchy as build_j
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration as cycle_t, build_device_hierarchy

    h_t = build_device_hierarchy(ml_t, device="cpu", dtype=torch.float64, **build_kw)
    h_j = build_j(ml_j, dtype=jnp.float64)
    B = rhs_block(n, pad=h_t.fine_padded - n, seed=seed)
    want = np.asarray(cycle_j(h_j, amg.V(), jnp.zeros(B.shape), jnp.asarray(B.numpy())))
    got = cycle_t(h_t, amt.V(), torch.zeros_like(B), B).numpy()
    return h_t, got, want


# --------------------------------------------------------------------------
# the generic sharded tier (``parallel.solve_sharded``): what one rank
# computes, on the problems of tests/test_multichip.py
# --------------------------------------------------------------------------

# name -> (replicate_below, dtype of build_sharded_hierarchy)
DIST_PROBLEMS = {"rs48": (1024, None), "sa32": (512, None), "lat144": (256, "float64"), "gs32": (512, None)}
DIST_RHS = 3  # columns of the multi-RHS block


def dist_problem(pkg, name):
    """(ml, b = A·1) of a named problem of tests/test_multichip.py (and
    ``gs32``, RS with its default natural-order GS), set up by ``pkg`` (the
    JAX package or the port)."""
    if name == "rs48":
        gs = pkg.GaussSeidel(ordering="multicolor")
        A = pkg.poisson((48, 48))
        ml = pkg.ruge_stuben(A, presmoother=gs, postsmoother=gs)
    elif name == "sa32":
        jac = pkg.Jacobi(0.6, iter=2)
        A = pkg.poisson((32, 32))
        ml = pkg.smoothed_aggregation(A, presmoother=jac, postsmoother=jac)
    elif name == "gs32":  # the default natural-order GS: a sequential sweep on a sharded ELL level
        A = pkg.poisson((32, 32))
        ml = pkg.ruge_stuben(A)
    else:
        A = pkg.poisson((144, 144), lattice=True)
        ml = pkg.structured_smoothed_aggregation(
            A, proxy=64, cut_rows=2000, min_proxy_dim=16, aggregate=pkg.StructuredAggregation(box=3),
        )
    return ml, A @ np.ones(A.shape[0])


def _op_arrays(E):
    """(held as a row block, the rank's arrays) of a level operator."""
    from algebraicmultigrid_tpu_torch.parallel.rows import ShardedOp

    blocked = isinstance(E, ShardedOp)
    F = E.local if blocked else E
    arr = getattr(F, "data", getattr(F, "mat", None))
    return blocked, None if arr is None else arr.cpu().numpy()


def _smoother_arrays(c):
    from algebraicmultigrid_tpu_torch.parallel.rows import ShardedSmoother

    blocked = isinstance(c, ShardedSmoother)
    c = c.cache if blocked else c
    return blocked, type(c).__name__, {f: getattr(c, f).cpu().numpy() for f in ("dinv", "color_of", "diag")
                                       if hasattr(c, f)}


def dist_rank(mesh):
    """One rank's results of the generic tier: each problem's layout (per
    level: A, P, R and the pre/post smoothers, whether held as a row block
    and the rank's arrays), its ``solve_sharded`` (x, iterations, ‖r‖) to
    1e-8 (the lattice float64 to 1e-6; SA with a W cycle), the RS problem
    on a [n, 3] block, and one V-cycle from zero on the lattice."""
    import torch

    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.models.device import _one_iteration
    from algebraicmultigrid_tpu_torch.parallel import build_sharded_hierarchy, solve_sharded

    out = {}
    for name, (below, dtype) in DIST_PROBLEMS.items():
        ml, b = dist_problem(amt, name)
        h = build_sharded_hierarchy(ml, mesh, dtype=dtype, replicate_below=below)
        out[name, "layout"] = [
            {"A": _op_arrays(L.A), "P": _op_arrays(L.P), "R": _op_arrays(L.R),
             "pre": _smoother_arrays(L.pre), "post": _smoother_arrays(L.post), "fused": L.fused}
            for L in h.levels
        ]
        out[name, "caches"] = (h.tail, h.sub)
        cycle = amt.W() if name == "sa32" else amt.V()
        reltol = 1e-6 if name == "lat144" else 1e-8
        out[name, "solve"] = solve_sharded(ml, b, cycle, mesh=mesh, reltol=reltol, dtype=dtype, replicate_below=below)
        if name == "rs48":
            B = np.random.default_rng(5).standard_normal((b.shape[0], DIST_RHS))
            out[name, "block"] = solve_sharded(ml, B, mesh=mesh, reltol=1e-8, replicate_below=below)
        if name == "lat144":
            bp = torch.zeros(h.fine_padded, dtype=torch.float64, device=mesh.device)
            bp[: b.shape[0]] = torch.as_tensor(np.random.default_rng(6).standard_normal(b.shape[0]))
            out[name, "vcycle"] = _one_iteration(h, amt.V(), torch.zeros_like(bp), bp).cpu().numpy()
    return out


# the coarse stencil's reach over-listed for the last level, whose child is
# the dense coarse matrix (absent couplings come back 0)
RAP_LAST_OFFSETS = tuple((du, dv) for du in range(-2, 3) for dv in range(-2, 3))


def rap_rank(mesh):
    """One rank's ``rap_planes_sharded`` of the 216² slab hierarchy
    (float32): at L0 (sharded on several ranks), with its host child's
    offsets, and at the last level (replicated on every mesh), with
    ``RAP_LAST_OFFSETS``; (level index, planes, sharded) each."""
    import algebraicmultigrid_tpu_torch as amt
    from algebraicmultigrid_tpu_torch.parallel import build_slab_hierarchy, rap_planes_sharded

    ml = slab_problem(amt)
    h = build_slab_hierarchy(ml, mesh.n_sh).to_rank(mesh.rank, mesh.device)
    last = len(h.levels) - 1
    return {
        key: (li, rap_planes_sharded(h, li, mesh, offs).cpu().numpy(), h.levels[li].sharded)
        for key, li, offs in (("sharded", 0, ml.levels[1].A.spec.offsets), ("replicated", last, RAP_LAST_OFFSETS))
    }
