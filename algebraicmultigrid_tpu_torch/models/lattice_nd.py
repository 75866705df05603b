"""N-dimensional lattice fast path — 3-D (and any-D) structured setup.

Port of the JAX package's ``models/lattice_nd.py`` (numpy/scipy, unchanged).

The reference gallery is N-dimensional (AlgebraicMultigrid.jl
``src/gallery.jl:42-61``); the 2-D lattice tier (models/lattice.py + fastsetup.py) covers the flagship
4096² configuration but is strictly 2-axis.  This module generalises the
proxy-extrapolated O(boundary) setup and the gather-free device lowering to
N axes, so ``poisson((256,256,256))`` gets a structured hierarchy with
shift-multiply (diagonal-slice) device operators instead of the generic
O(nnz) host pipeline + gather SpMV.

Same architecture as the 2-D tier:

1. run the *generic* SA pipeline on a small N-D proxy grid (periodic box
   aggregation with known dims — no detection needed),
2. extract per level the (offset × boundary-class^N) coefficient tables of
   A/P/R with an exact round-trip check,
3. re-instantiate at full size as :class:`LatticeMatrixND` levels; the
   device engine lowers them to :class:`~..ops.lattice_nd_op.LatND`
   (per-axis strided slices — zero gathers), and smooths a 3-D level with
   the whole-sweep kernel K7 (``ops/kernels/sweep3d.py``) under an N-D
   periodic coloring, other levels with the masked multicolor sweep,
4. below the cut, assemble to scipy and continue with the untouched generic
   setup (reference semantics preserved exactly).

Per-axis class machinery (``axis_classes`` etc.) is shared with the 2-D
module.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from .lattice import (
    _axis_params,
    axis_classes,
    class_populations,
    derive_base,
    n_axis_classes,
)

__all__ = [
    "LatticeSpecND",
    "LatticeMatrixND",
    "LatticeProblemND",
    "extract_spec_nd",
    "lattice_coloring_nd",
    "BoxAggregationND",
    "structured_smoothed_aggregation_nd",
]


@dataclasses.dataclass(frozen=True)
class LatticeSpecND:
    """Coefficient table of an N-D translation-invariant-with-boundary
    operator: ``table[k, c_0, …, c_{N-1}]`` is the coefficient of geometric
    offset ``offsets[k]`` for rows whose axis classes are ``(c_0, …)``.
    The column lattice point of row ``(i_0, …)`` at offset ``d`` is
    ``((i_a·p_a)//q_a + d_a)`` per axis with rational bases ``bases[a]``."""

    offsets: Tuple[Tuple[int, ...], ...]
    table: np.ndarray  # [n_off, *n_classes_per_axis]
    row_dims: Tuple[int, ...]
    col_dims: Tuple[int, ...]
    Ks: Tuple[int, ...]
    ss: Tuple[int, ...]
    bases: Tuple[Tuple[int, int], ...]

    @property
    def ndim(self) -> int:
        return len(self.row_dims)

    @property
    def dtype(self):
        return self.table.dtype

    def with_dims(self, row_dims, col_dims) -> "LatticeSpecND":
        for W_r, W_c, (p, q) in zip(row_dims, col_dims, self.bases):
            assert ((W_r - 1) * p) // q <= W_c - 1, (row_dims, col_dims, p, q)
        return dataclasses.replace(
            self, row_dims=tuple(row_dims), col_dims=tuple(col_dims)
        )

    def nnz(self) -> int:
        pops = [
            class_populations(W, K, s)
            for W, K, s in zip(self.row_dims, self.Ks, self.ss)
        ]
        nz = (self.table != 0).astype(np.int64)
        for p in pops:
            nz = np.tensordot(nz, p, axes=([1], [0]))
        return int(nz.sum())

    def row_class_arrays(self) -> List[np.ndarray]:
        return [
            axis_classes(np.arange(W), W, K, s)
            for W, K, s in zip(self.row_dims, self.Ks, self.ss)
        ]

    def _axis_selectors(self, W: int, K: int, s: int):
        sel: List = list(range(K))
        for r in range(s):
            start = K + ((r - K) % s)
            sel.append(slice(start, W - K, s))
        sel += [W - K + t for t in range(K)]
        return sel

    def expand(self, k: int, dtype=None, out=None) -> np.ndarray:
        """Full row-grid coefficient array for offset k via strided block
        fills (O(n) memset-speed writes, no gathers)."""
        T = self.table[k]
        if dtype is None:
            dtype = T.dtype
        if out is None:
            out = np.empty(self.row_dims, dtype=dtype)
        sels = [
            self._axis_selectors(W, K, s)
            for W, K, s in zip(self.row_dims, self.Ks, self.ss)
        ]
        for cell in itertools.product(*(range(len(s)) for s in sels)):
            out[tuple(sels[a][c] for a, c in enumerate(cell))] = T[cell]
        return out

    def expand_all(self, dtype=None) -> np.ndarray:
        if dtype is None:
            dtype = self.table.dtype
        out = np.empty((len(self.offsets),) + tuple(self.row_dims), dtype=dtype)
        for k in range(len(self.offsets)):
            self.expand(k, dtype=dtype, out=out[k])
        return out

    def diagonal(self) -> np.ndarray:
        zero = tuple(0 for _ in self.row_dims)
        for k, d in enumerate(self.offsets):
            if tuple(d) == zero:
                return self.expand(k).ravel()
        return np.zeros(int(np.prod(self.row_dims)), dtype=self.table.dtype)

    def _bases_points(self):
        return [
            (np.arange(W) * p) // q
            for W, (p, q) in zip(self.row_dims, self.bases)
        ]

    def tocsr(self) -> sp.csr_matrix:
        n_r = int(np.prod(self.row_dims))
        n_c = int(np.prod(self.col_dims))
        base_pts = self._bases_points()
        row_grid = np.arange(n_r).reshape(self.row_dims)
        rows_acc, cols_acc, vals_acc = [], [], []
        col_strides = np.cumprod([1] + list(self.col_dims[::-1]))[::-1][1:]
        for k, d in enumerate(self.offsets):
            V = self.expand(k)
            js = [bp + dd for bp, dd in zip(base_pts, d)]
            oks = [
                (j >= 0) & (j < Wc) for j, Wc in zip(js, self.col_dims)
            ]
            mask = V != 0
            colg = np.zeros(self.row_dims, dtype=np.int64)
            for a in range(self.ndim):
                shape = [1] * self.ndim
                shape[a] = -1
                mask = mask & oks[a].reshape(shape)
                colg = colg + np.clip(js[a], 0, self.col_dims[a] - 1).reshape(shape) * col_strides[a]
            if not mask.any():
                continue
            rows_acc.append(row_grid[mask])
            cols_acc.append(colg[mask])
            vals_acc.append(V[mask])
        if not rows_acc:
            return sp.csr_matrix((n_r, n_c), dtype=self.table.dtype)
        M = sp.coo_matrix(
            (np.concatenate(vals_acc), (np.concatenate(rows_acc), np.concatenate(cols_acc))),
            shape=(n_r, n_c),
        ).tocsr()
        M.sum_duplicates()
        M.sort_indices()
        return M

    def matvec(self, x: np.ndarray) -> np.ndarray:
        n_c = int(np.prod(self.col_dims))
        tail = x.shape[1:]
        X = x[:n_c].reshape(tuple(self.col_dims) + tail)
        margins = [
            max((abs(d[a]) for d in self.offsets), default=0)
            for a in range(self.ndim)
        ]
        Xp = np.pad(X, [(m, m) for m in margins] + [(0, 0)] * len(tail))
        base_pts = self._bases_points()
        y = np.zeros(tuple(self.row_dims) + tail, dtype=np.result_type(self.table.dtype, x.dtype))
        for k, d in enumerate(self.offsets):
            V = self.expand(k)
            if tail:
                V = V[(...,) + (None,) * len(tail)]
            idx = np.ix_(*[bp + dd + m for bp, dd, m in zip(base_pts, d, margins)])
            y += V * Xp[idx]
        return y.reshape((int(np.prod(self.row_dims)),) + tail)


# --------------------------------------------------------------------------
# extraction from a proxy matrix
# --------------------------------------------------------------------------


def extract_spec_nd(
    M,
    row_dims: Sequence[int],
    col_dims: Sequence[int],
    *,
    K: int = 6,
    max_offsets: int = 150,
    verify: bool = True,
    min_margin: int = 8,
    iter_candidates: bool = False,
):
    """Extract the (offset, class^N) table of a proxy operator; None if the
    operator is not lattice-structured under these dims.  ``verify`` round-
    trips through :meth:`tocsr` and compares exactly (extraction can never
    silently corrupt an operator) — the same contract as the 2-D
    ``extract_spec`` (models/lattice.py).  With ``iter_candidates`` a
    generator over ALL round-trip-exact (K, s) candidates is returned
    (evidenced-interior ones first): different class layouts can be on-proxy
    identical yet extrapolate differently, and only an external check — the
    driver's second-proxy verification — can tell them apart."""
    row_dims = tuple(int(w) for w in row_dims)
    col_dims = tuple(int(w) for w in col_dims)
    N = len(row_dims)
    M = sp.csr_matrix(M)
    if M.nnz and np.count_nonzero(M.data) != M.nnz:
        M = M.copy()
        M.eliminate_zeros()
    M.sort_indices()
    if M.shape != (int(np.prod(row_dims)), int(np.prod(col_dims))) or M.nnz == 0:
        return None
    if np.iscomplexobj(M.data):
        return None

    bases = []
    for Wr, Wc in zip(row_dims, col_dims):
        b = derive_base(Wr, Wc)
        if b is None:
            return None
        bases.append(b)

    rows = np.repeat(np.arange(M.shape[0]), np.diff(M.indptr))
    cols = M.indices.astype(np.int64)
    # unravel row/col multi-indices
    ri = np.unravel_index(rows, row_dims)
    ci = np.unravel_index(cols, col_dims)
    ds = [
        ci[a] - (ri[a] * bases[a][0]) // bases[a][1] for a in range(N)
    ]

    packed = np.zeros(len(rows), dtype=np.int64)
    for d in ds:
        packed = packed * (1 << 20) + (d.astype(np.int64) + (1 << 19))
    uniq, kidx = np.unique(packed, return_inverse=True)
    if len(uniq) > max_offsets:
        return None
    offs = np.zeros((len(uniq), N), dtype=np.int64)
    rem = uniq.copy()
    for a in range(N - 1, -1, -1):
        offs[:, a] = rem % (1 << 20) - (1 << 19)
        rem = (rem - (rem % (1 << 20))) // (1 << 20)
    dmax = [int(np.abs(offs[:, a]).max()) for a in range(N)]

    min_margin = max(0, min_margin)
    K_list = [max(K, min_margin), K + 3, K + 6]
    if min_margin < 8:
        K_list += list(range(max(K, min_margin) - 1, min_margin - 1, -1))
    cands, seen = [], set()
    for K_try in K_list:
        for s in (1, 2, 3, 4, 6):
            Ks, ss = [], []
            ok = True
            for a, W in enumerate(row_dims):
                Ka, sa = _axis_params(W, K_try, s)
                if W > 1 and Ka < min_margin:
                    ok = False
                    break
                if W > 1 and Ka < min(dmax[a] + 1, (W - sa) // 2):
                    Ka = min(dmax[a] + 1, (W - sa) // 2)
                if 2 * Ka + sa > W:
                    ok = False
                    break
                Ks.append(Ka)
                ss.append(sa)
            if not ok or (tuple(Ks), tuple(ss)) in seen:
                continue
            seen.add((tuple(Ks), tuple(ss)))
            cands.append((Ks, ss))
    # Interior classes holding ≥ 2 positions give EVIDENCED invariance (two
    # same-class rows agreed); single-member classes are trivially
    # consistent but extrapolate blindly (the degenerate 2K+s == W case
    # most of all).  Try candidates with the fewest unevidenced interior
    # classes first, so a correct table preempts a degenerate one when
    # both pass the on-proxy checks (ties keep the original K/s order).
    def evidence_key(c):
        Ks, ss = c
        any_single, interior = False, 0
        for W, Ka, sa in zip(row_dims, Ks, ss):
            if W <= 1:
                continue
            pops = class_populations(W, Ka, sa)[Ka : Ka + sa]
            any_single |= bool((pops < 2).any())
            interior += W - 2 * Ka
        return (any_single, -interior)

    def gen():
        for Ks, ss in sorted(cands, key=evidence_key):
            spec = _try_extract_nd(
                M, kidx, ri, offs, row_dims, col_dims, Ks, ss, bases
            )
            if spec is None:
                continue
            if verify:
                R = spec.tocsr()
                if R.shape != M.shape or R.nnz != M.nnz:
                    continue
                D = (R - M).tocoo()
                if D.nnz and np.abs(D.data).max() != 0:
                    continue
            yield spec

    if iter_candidates:
        return gen()
    for spec in gen():
        return spec
    return None


def _try_extract_nd(M, kidx, ri, offs, row_dims, col_dims, Ks, ss, bases):
    N = len(row_dims)
    ncls = [n_axis_classes(K, s) for K, s in zip(Ks, ss)]
    n_off = len(offs)
    vals = M.data

    flat = kidx.astype(np.int64)
    for a in range(N):
        ca = axis_classes(ri[a], row_dims[a], Ks[a], ss[a])
        flat = flat * ncls[a] + ca

    size = n_off * int(np.prod(ncls))
    table = np.zeros(size, dtype=M.data.dtype)
    table[flat] = vals
    if not np.array_equal(table[flat], vals):
        return None
    cnt = np.bincount(flat, minlength=size)
    pop = np.ones(1, dtype=np.int64)
    for W, K, s in zip(row_dims, Ks, ss):
        pop = np.multiply.outer(pop, class_populations(W, K, s))
    pop = pop.reshape(-1)
    pop_full = np.tile(pop, n_off)
    if not ((cnt == 0) | (cnt == pop_full)).all():
        return None

    return LatticeSpecND(
        offsets=tuple(tuple(int(v) for v in row) for row in offs),
        table=table.reshape((n_off,) + tuple(ncls)),
        row_dims=tuple(row_dims),
        col_dims=tuple(col_dims),
        Ks=tuple(Ks),
        ss=tuple(ss),
        bases=tuple(bases),
    )


# --------------------------------------------------------------------------
# periodic multicolor ordering (N-D torus)
# --------------------------------------------------------------------------


def lattice_coloring_nd(spec: LatticeSpecND, max_period: int = 4):
    """Minimal periodic proper coloring of a square N-D lattice operator —
    the N-D generalisation of ``lattice_coloring`` (models/lattice.py:481)."""
    zero = tuple(0 for _ in spec.row_dims)
    offs = [
        tuple(d)
        for k, d in enumerate(spec.offsets)
        if tuple(d) != zero and np.any(spec.table[k])
    ]
    N = spec.ndim
    if not offs:
        return np.zeros((1,) * N, dtype=np.int32), 1
    best = None
    for periods in itertools.product(range(1, max_period + 1), repeat=N):
        if any(all(d[a] % periods[a] == 0 for a in range(N)) for d in offs):
            continue  # an offset maps a cell to itself — uncolorable
        colors = -np.ones(periods, dtype=np.int32)
        for cell in itertools.product(*(range(p) for p in periods)):
            used = set()
            for d in offs:
                for sgn in (1, -1):
                    nb = tuple((cell[a] + sgn * d[a]) % periods[a] for a in range(N))
                    w = colors[nb]
                    if w >= 0:
                        used.add(int(w))
            c = 0
            while c in used:
                c += 1
            colors[cell] = c
        nc = int(colors.max()) + 1
        if best is None or nc < best[1] or (nc == best[1] and colors.size < best[0].size):
            best = (colors, nc)
    return best


# --------------------------------------------------------------------------
# user-facing operator objects
# --------------------------------------------------------------------------


class LatticeMatrixND:
    """Full-size N-D lattice operator defined by a :class:`LatticeSpecND`.
    Duck-types the scipy surface the hierarchy machinery touches."""

    def __init__(self, spec: LatticeSpecND):
        self.spec = spec
        self._csr = None
        self._nnz = None

    @property
    def shape(self):
        return (
            int(np.prod(self.spec.row_dims)),
            int(np.prod(self.spec.col_dims)),
        )

    @property
    def dtype(self):
        return self.spec.table.dtype

    @property
    def nnz(self) -> int:
        if self._nnz is None:
            self._nnz = self.spec.nnz()
        return self._nnz

    def __matmul__(self, x):
        return self.spec.matvec(np.asarray(x))

    def dot(self, x):
        return self @ x

    def diagonal(self) -> np.ndarray:
        return self.spec.diagonal()

    def tocsr(self) -> sp.csr_matrix:
        if self._csr is None:
            self._csr = self.spec.tocsr()
        return self._csr

    def tocsc(self) -> sp.csc_matrix:
        return self.tocsr().tocsc()

    def toarray(self) -> np.ndarray:
        return self.tocsr().toarray()

    def __repr__(self):
        return (
            f"LatticeMatrixND(dims={self.spec.row_dims}→{self.spec.col_dims}, "
            f"{len(self.spec.offsets)} offsets)"
        )


class LatticeProblemND(LatticeMatrixND):
    """Boundary-clipped N-D stencil operator in symbolic lattice form —
    the N-D gallery entry (gallery.jl:42-61 semantics)."""

    def __init__(self, stencil: np.ndarray, dims: Sequence[int], dtype=np.float64):
        stencil = np.asarray(stencil, dtype=dtype)
        dims = tuple(int(d) for d in dims)
        N = len(dims)
        if stencil.ndim != N:
            raise ValueError("stencil rank must match dims")
        centers = tuple(s // 2 for s in stencil.shape)
        offsets, tables = [], []
        Ks = tuple(_axis_params(W, max(s // 2 for s in stencil.shape), 1)[0] for W in dims)
        ss = (1,) * N
        ncls = [n_axis_classes(K, s) for K, s in zip(Ks, ss)]
        for cell in itertools.product(*(range(s) for s in stencil.shape)):
            v = stencil[cell]
            if v == 0:
                continue
            d = tuple(c - ctr for c, ctr in zip(cell, centers))
            offsets.append(d)
            # boundary clipping: coefficient is 0 for rows whose column
            # point would leave the grid — encode per axis class
            tab = np.full(ncls, v, dtype=dtype)
            for a in range(N):
                cls_pos = _class_positions(dims[a], Ks[a], ss[a])
                bad = (cls_pos + d[a] < 0) | (cls_pos + d[a] > dims[a] - 1)
                sel = [slice(None)] * N
                sel[a] = bad
                tab[tuple(sel)] = 0
            tables.append(tab)
        spec = LatticeSpecND(
            offsets=tuple(offsets),
            table=np.stack(tables),
            row_dims=dims,
            col_dims=dims,
            Ks=Ks,
            ss=ss,
            bases=((1, 1),) * N,
        )
        super().__init__(spec)


def _class_positions(W: int, K: int, s: int) -> np.ndarray:
    """A representative grid position per axis class (interior classes use a
    mid-grid anchor so ±reach never leaves the grid)."""
    pos = list(range(K))
    for r in range(s):
        pos.append(K + ((r - K) % s) + s * max(0, (W - 2 * K) // (2 * s)))
    pos += [W - K + t for t in range(K)]
    return np.asarray(pos)


# --------------------------------------------------------------------------
# periodic box aggregation with known dims (proxy driver)
# --------------------------------------------------------------------------


class BoxAggregationND:
    """Axis-aligned ``box^N`` aggregation over an explicitly tracked dims
    chain (the proxy driver knows its grids — no pattern detection).  Each
    call consumes the next level's dims; mirrors
    ``StructuredAggregation`` (models/structured.py:140) semantics."""

    def __init__(self, dims: Sequence[int], box: int = 3):
        self.box = int(box)
        self._dims = tuple(int(d) for d in dims)

    def __call__(self, S):
        n = S.shape[0]
        dims = self._dims
        if int(np.prod(dims)) != n:
            raise ValueError(f"dims {dims} do not match n={n}")
        k = self.box
        cdims = tuple((W + k - 1) // k for W in dims)
        idx = np.unravel_index(np.arange(n), dims)
        agg = np.zeros(n, dtype=np.int64)
        for a, W in enumerate(dims):
            agg = agg * cdims[a] + idx[a] // k
        self._dims = cdims  # advance the chain for the next level
        return sp.csr_matrix(
            (np.ones(n, dtype=np.float64), (agg, np.arange(n))),
            shape=(int(np.prod(cdims)), n),
        )


# --------------------------------------------------------------------------
# grid-vector extraction (near-null-space candidates)
# --------------------------------------------------------------------------


def extract_grid_vector_nd(v: np.ndarray, dims, K: int = 8):
    """(table, (Ks, ss)) for a boundary-classed N-D grid function; None if
    rows of the same class disagree (fastsetup.extract_grid_vector, N-D)."""
    dims = tuple(int(d) for d in dims)
    v = np.asarray(v)
    if v.shape[0] != int(np.prod(dims)):
        return None
    for K_try, s in [(k, s) for k in (K, 6, 4) for s in (1, 2, 3, 4, 6)]:
        Ks, ss = [], []
        ok = True
        for W in dims:
            Ka = K_try if W >= 2 * K_try + s else max((W - s) // 2, 0)
            sa = s if W > 1 else 1
            if 2 * Ka + sa > W:
                ok = False
                break
            Ks.append(Ka)
            ss.append(sa)
        if not ok:
            continue
        ncls = [n_axis_classes(K_, s_) for K_, s_ in zip(Ks, ss)]
        cls = [
            axis_classes(np.arange(W), W, K_, s_)
            for W, K_, s_ in zip(dims, Ks, ss)
        ]
        flat = np.zeros(int(np.prod(dims)), dtype=np.int64).reshape(dims)
        for a in range(len(dims)):
            shape = [1] * len(dims)
            shape[a] = -1
            flat = flat * ncls[a] + cls[a].reshape(shape)
        flat = flat.ravel()
        size = int(np.prod(ncls))
        lo = np.full(size, np.inf)
        hi = np.full(size, -np.inf)
        np.minimum.at(lo, flat, v)
        np.maximum.at(hi, flat, v)
        seen = np.zeros(size, dtype=bool)
        seen[flat] = True
        if np.any(seen & (hi != lo)):
            continue
        table = np.where(seen, lo, 0.0).reshape(ncls)
        return table, (tuple(Ks), tuple(ss))
    return None


def instantiate_grid_vector_nd(table, meta, dims) -> np.ndarray:
    Ks, ss = meta
    cls = [
        axis_classes(np.arange(W), W, K, s) for W, K, s in zip(dims, Ks, ss)
    ]
    return table[np.ix_(*cls)].ravel()


def _phase_ok_nd(Ks_ss, fdims, pdims) -> bool:
    ss = Ks_ss if isinstance(Ks_ss[0], int) else Ks_ss[1]
    return all((f - p) % s == 0 for f, p, s in zip(fdims, pdims, ss))


# --------------------------------------------------------------------------
# the proxy-extrapolated SA driver
# --------------------------------------------------------------------------


def _proxy_dims_nd(full, target: int, k: int, depth: int = 3):
    mod = k ** depth
    out = []
    for W in full:
        if W <= target:
            out.append(W)
        else:
            pw = target + ((W - target) % mod)
            out.append(pw if pw <= W // 2 else target + ((W - target) % 12))
    return tuple(out)


def structured_smoothed_aggregation_nd(
    problem: LatticeMatrixND,
    *,
    proxy: int = 40,
    cut_rows: int = 15_000,
    min_proxy_dim: int = 9,
    box: int = 3,
    presmoother=None,
    postsmoother=None,
    improve_candidates=None,
    max_levels: int = 10,
    max_coarse: int = 10,
    **kwargs,
):
    """Smoothed-aggregation AMG for an N-D lattice problem at O(boundary)
    setup cost: generic SA on a congruent proxy grid + per-level table
    extraction + full-size instantiation (see module docstring).  Matches
    ``smoothed_aggregation(A, aggregate=BoxAggregationND(dims, box),
    improve_candidates=Jacobi(0.5, 4))`` exactly on the fast levels; the
    tail below the cut runs that very pipeline."""
    from ..config import GaussSeidel, Jacobi
    from ..utils.symmetry import HermitianSymmetry
    from .aggregation import smoothed_aggregation
    from .multilevel import Level, MultiLevel

    if presmoother is None:
        presmoother = GaussSeidel(ordering="multicolor")
    if postsmoother is None:
        postsmoother = GaussSeidel(ordering="multicolor")
    if improve_candidates is None:
        improve_candidates = Jacobi(omega=0.5, iter=4)

    def generic(A_like, levels_left, dims, B_arg=None):
        A_csr = A_like.tocsr() if isinstance(A_like, LatticeMatrixND) else A_like
        return smoothed_aggregation(
            A_csr,
            B=B_arg,
            aggregate=BoxAggregationND(dims, box),
            improve_candidates=improve_candidates,
            presmoother=presmoother,
            postsmoother=postsmoother,
            max_levels=levels_left,
            max_coarse=max_coarse,
            **kwargs,
        )

    fdims = tuple(problem.spec.row_dims)
    n_full = int(np.prod(fdims))
    if n_full <= 4 * cut_rows:
        return generic(problem, max_levels, fdims)
    # candidate proxy sizes, smallest first; a failed walk (0 fast levels —
    # proxy too small to evidence the deeper belts) retries with the next
    pd_cands = []
    for depth in (3, 4, 5):
        pd = _proxy_dims_nd(fdims, proxy, k=box, depth=depth)
        if pd not in pd_cands:
            pd_cands.append(pd)
    pd_cands.sort(key=lambda pd: int(np.prod(pd)))
    out = None
    for pdims in pd_cands:
        out = _sa_nd_attempt(
            problem, fdims, pdims, generic, box, cut_rows, min_proxy_dim,
            max_levels, max_coarse, proxy, presmoother, postsmoother,
        )
        if out is not None:
            return out
    return generic(problem, max_levels, fdims)


def _sa_nd_attempt(
    problem, fdims, pdims, generic, box, cut_rows, min_proxy_dim,
    max_levels, max_coarse, proxy, presmoother, postsmoother,
):
    """One proxy-size attempt of the N-D fast path; None → caller retries
    with a bigger proxy or falls back to the generic pipeline."""
    from ..utils.symmetry import HermitianSymmetry
    from .multilevel import Level, MultiLevel

    # second, larger proxy for EMPIRICAL invariance verification: tables
    # extracted at p are instantiated at q and compared exactly against a
    # real setup at q.  Two independent sizes agreeing establishes the
    # translation invariance that the 2-D tier's conservative min_margin=8
    # rule guards heuristically — and permits tiny-margin extraction of
    # small coarse proxies (boundary-belt values frozen as "interior" at p
    # would land on genuine interior positions of q and mismatch → cut).
    qstep = box * box
    qdims = tuple(p + qstep if f > p else p for f, p in zip(fdims, pdims))
    if (
        min(pdims) < min_proxy_dim
        # the q-proxy verification is the safety net; the full grid only
        # needs to strictly exceed it per coarsened axis
        or any(f <= q for f, q in zip(fdims, qdims) if f > proxy)
    ):
        return None

    A_proxy = problem.spec.with_dims(pdims, pdims).tocsr()
    ml_p = generic(A_proxy, max_levels, pdims)
    B_per_level = getattr(ml_p, "_B_per_level", None) or []
    A_q = problem.spec.with_dims(qdims, qdims).tocsr()
    ml_q = generic(A_q, max_levels, qdims)
    B_q = getattr(ml_q, "_B_per_level", None) or []

    def q_match(spec_p, q_rows, q_cols, M_q) -> bool:
        """Instantiate p-extracted tables at the q dims; exact-compare."""
        try:
            R = spec_p.with_dims(q_rows, q_cols).tocsr()
        except AssertionError:
            return False
        M_q = sp.csr_matrix(M_q)
        if R.shape != M_q.shape or R.nnz != M_q.nnz:
            return False
        D = (R - M_q).tocoo()
        return D.nnz == 0 or np.abs(D.data).max() == 0

    fast_levels: List = []
    spec_A = problem.spec
    cur_p, cur_q, cur_f = pdims, qdims, fdims
    lvl = 0
    while True:
        n_rows = int(np.prod(cur_f))
        remaining = max_levels - len(fast_levels)
        if (
            lvl >= len(ml_p.levels)
            or lvl >= len(ml_q.levels)
            or n_rows <= cut_rows
            or n_rows <= max_coarse
            or remaining <= 1
            or min(cur_p) < min_proxy_dim
        ):
            break
        cd = tuple((W + box - 1) // box for W in cur_p)
        qd = tuple((W + box - 1) // box for W in cur_q)
        fd_c = tuple((W + box - 1) // box for W in cur_f)
        if any((f % box) != (p % box) or (q % box) != (p % box)
               for f, p, q in zip(cur_f, cur_p, cur_q)):
            break
        P_p = sp.csr_matrix(ml_p.levels[lvl].P)
        if P_p.shape[1] != int(np.prod(cd)):
            break

        def pick(Mp, rd, cdd, Mq, q_rows, q_cols, full_rows):
            """First extraction candidate whose phases fit the full AND
            verification grids and whose q-instantiation matches exactly —
            on-proxy-identical class layouts extrapolate differently, so
            the q-proxy is the selector, not just a gate."""
            # extract_spec_nd returns None, not an empty generator, for a
            # matrix it rejects outright (the JAX package's copy raises
            # TypeError there)
            for s in extract_spec_nd(
                sp.csr_matrix(Mp), rd, cdd, min_margin=1, iter_candidates=True
            ) or ():
                if not (
                    _phase_ok_nd(s.ss, full_rows, rd)
                    and _phase_ok_nd(s.ss, q_rows, rd)
                ):
                    continue
                if q_match(s, q_rows, q_cols, Mq):
                    return s
            return None

        sP = pick(ml_p.levels[lvl].P, cur_p, cd, ml_q.levels[lvl].P, cur_q, qd, cur_f)
        sR = pick(ml_p.levels[lvl].R, cd, cur_p, ml_q.levels[lvl].R, qd, cur_q, fd_c)
        sA = spec_A if lvl == 0 else pick(
            ml_p.levels[lvl].A, cur_p, cur_p, ml_q.levels[lvl].A, cur_q, cur_q, cur_f
        )
        A_next_p = (
            ml_p.levels[lvl + 1].A
            if lvl + 1 < len(ml_p.levels)
            else ml_p.final_A
        )
        A_next_q = (
            ml_q.levels[lvl + 1].A
            if lvl + 1 < len(ml_q.levels)
            else ml_q.final_A
        )
        sA_next = pick(A_next_p, cd, cd, A_next_q, qd, qd, fd_c)
        if sP is None or sR is None or sA is None or sA_next is None:
            break
        if lvl + 1 >= len(B_per_level) or lvl + 1 >= len(B_q):
            break
        gotB = extract_grid_vector_nd(B_per_level[lvl + 1], cd)
        if gotB is None or not _phase_ok_nd(gotB[1], fd_c, cd) or not _phase_ok_nd(gotB[1], qd, cd):
            break
        # B verification at q (exact)
        Bq_pred = instantiate_grid_vector_nd(gotB[0], gotB[1], qd)
        if not np.array_equal(Bq_pred, np.asarray(B_q[lvl + 1])):
            break

        A_f = problem if lvl == 0 else LatticeMatrixND(spec_A.with_dims(cur_f, cur_f))
        lvl_f = Level(
            A=A_f,
            P=LatticeMatrixND(sP.with_dims(cur_f, fd_c)),
            R=LatticeMatrixND(sR.with_dims(fd_c, cur_f)),
            presmoother_config=presmoother,
            postsmoother_config=postsmoother,
            symmetry=HermitianSymmetry(),
        )
        fast_levels.append(lvl_f)
        spec_A = sA_next
        cur_p, cur_q, cur_f = cd, qd, fd_c
        lvl += 1

    if not fast_levels:
        return None  # caller retries with a bigger proxy, then generic

    n_cut = len(fast_levels)
    gotB = extract_grid_vector_nd(B_per_level[n_cut], cur_p)
    if gotB is None:
        return None
    B_cut_full = instantiate_grid_vector_nd(gotB[0], gotB[1], cur_f)
    A_cut = LatticeMatrixND(spec_A.with_dims(cur_f, cur_f))
    tail = generic(A_cut, max_levels - n_cut, cur_f, B_cut_full)

    return MultiLevel(
        levels=fast_levels + tail.levels,
        final_A=tail.final_A,
        coarse_solver=tail.coarse_solver,
        symmetry=HermitianSymmetry(),
        dtype=problem.dtype,
    )
