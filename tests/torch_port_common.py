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


def setup_both(n=N, box=3):
    """(JAX hierarchy, port hierarchy) of poisson((n, n)) with box-k SA."""
    import algebraicmultigrid_tpu as amg
    import algebraicmultigrid_tpu_torch as amt

    ml_j = amg.structured_smoothed_aggregation(
        amg.poisson((n, n), lattice=True),
        aggregate=amg.StructuredAggregation(box=box), **SETUP_KW,
    )
    ml_t = amt.structured_smoothed_aggregation(
        amt.poisson((n, n), lattice=True),
        aggregate=amt.StructuredAggregation(box=box), **SETUP_KW,
    )
    return ml_j, ml_t


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


# the JAX fused-leg caches in a layout that untiles to full planes:
# no packed sweeps, no representative-tile compaction
PLAIN_TILES = dict(AMG_PALLAS_FUSED="1", AMG_PACKED_SWEEP="0", AMG_TILE_COMPACT="0")


def rel_err(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _lat2d(A):
    return dict(
        data=np.asarray(A.data), offsets=A.offsets, row_dims=A.row_dims,
        col_dims=A.col_dims, base_x=A.base_x, base_y=A.base_y, shape=A.shape,
        nnz=A.nnz, rows_padded=A.rows_padded,
    )


def _smoother(c):
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


def _fused(f):
    if f is None:
        return None
    assert f.factored and not f.packed and f.cA is None and not f.expand_in_kernel
    return dict(
        A=_untile(f.A_tiled, f), dinv=_untile(f.dinv_tiled, f),
        T=_untile(f.T_tiled, f), S=_untile(f.S_tiled, f),
        offsA=f.offsA, color_grid=f.color_grid, n_colors=f.n_colors, k=f.k,
        row_dims=f.row_dims, col_dims=f.col_dims, omega=f.omega, iter=f.iter,
        forward=f.forward, backward=f.backward,
    )


def jax_hierarchy_to_numpy(h):
    """(levels, coarse) dicts of a JAX DeviceHierarchy built under
    PLAIN_TILES (or with no fused legs)."""
    levels = [
        dict(
            A=_lat2d(L.A), P=_lat2d(L.P), R=_lat2d(L.R),
            pre=_smoother(L.pre), post=_smoother(L.post), fused=_fused(L.fused),
        )
        for L in h.levels
    ]
    c = h.coarse
    coarse = dict(
        kind=c.kind, n=c.n, rows_padded=c.rows_padded,
        mat=np.asarray(c.mat), qr_q=np.asarray(c.qr_q), qr_r=np.asarray(c.qr_r),
    )
    return levels, coarse


def jax_tail_to_numpy(h):
    """The ``tail`` dict of a JAX DeviceHierarchy's factored whole-tail
    cache: planes with the kernel's halo stripped, step metadata from the
    levels' smoothers, and Mc read back from the coarse planes G."""
    from algebraicmultigrid_tpu.ops.coloring import color_steps
    from algebraicmultigrid_tpu.ops.pallas.tail_kernel import _H

    t = h.tail
    levels = []
    for i, m in enumerate(t.metas):
        assert m.factored
        sm = h.levels[h.tail_start + i].pre
        assert color_steps(sm.n_colors, sm.iter, sm.forward, sm.backward, sm.omega) == m.steps
        Wx, Wy = m.dims
        crop = (Ellipsis, slice(_H, _H + Wx), slice(_H, _H + Wy))
        levels.append(dict(
            A=np.asarray(t.A[i])[crop], dinv=np.asarray(t.dinv[i])[crop],
            T=np.asarray(t.Tp[i])[crop], S=np.asarray(t.Sp[i])[crop],
            offsA=m.offsA, color_grid=m.color_grid, n_colors=sm.n_colors, k=m.k,
            row_dims=m.dims, col_dims=m.cdims, omega=m.omega, iter=sm.iter,
            forward=sm.forward, backward=sm.backward,
        ))
    W7x, W7y = t.dims7
    n7 = W7x * W7y
    G = np.asarray(t.G)[:, _H : _H + W7x, _H : _H + W7y]
    return dict(levels=levels, Mc=G.reshape(n7, n7).T)
