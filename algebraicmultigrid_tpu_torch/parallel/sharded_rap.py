"""Distributed Galerkin triple product for slab-sharded lattice levels.

Port of the JAX package's ``parallel/sharded_rap.py``: the coarse operator
of a slab-sharded lattice level computed on the ranks, with no global
operator on any of them.

Method — stencil probing: the coarse operator has bounded reach ``r_c``,
so applying ``R·A·P`` to the ``q² (q = 2r_c+1)`` periodic coarse
unit-impulse fields recovers every entry: probe ``(a, b)`` sets 1 on coarse
points ≡ (a, b) mod q, and since no two probe points' stencils overlap,
``(RAP e)[w]`` is ``A_c[w, c]`` for the unique in-reach probe point c.
Each probe reuses the slab cycle's own pieces (``lattice_cycle.py``): the
factored prolongation ``P = (I − diag(s)A)T``, the halo-exchange stencil
and the factored restriction with the stride-k box sum, so all
communication is the O(surface) halo exchange and each rank holds only its
own slabs.  The probe fields are made on the rank's device from indices
(no O(n) host arrays).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .dist import RowMesh
from .lattice_cycle import SlabHierarchy, _check_rank, _exch, _prolong_corr, _restrict, _subsample

__all__ = ["rap_planes_sharded"]


def rap_planes_sharded(h: SlabHierarchy, li: int, mesh: RowMesh, offsets_c: Sequence[Tuple[int, int]]):
    """Coarse-level coefficient planes of level ``li``'s Galerkin product on
    this rank: ``[n_off_c, loc_c, Wyc_p]`` (this rank's slab of the padded
    coarse grid ``pdims(li)/k``) on a sharded level, the whole
    ``[n_off_c, Wxc_p, Wyc_p]`` on a replicated one, where
    ``planes[j][w] = A_c[w, w + offsets_c[j]]``.  ``offsets_c`` is the
    structural reach of the coarse stencil (over-listing is safe: absent
    couplings come back 0).  ``h`` is this rank's hierarchy
    (``SlabHierarchy.to_rank``); every rank calls it."""
    _check_rank(h, mesh)
    lv = h.levels[li]
    k = lv.k
    sharded = lv.sharded and mesh.n_sh > 1
    Wxc, Wyc = lv.pdims[0] // k, lv.pdims[1] // k
    offsets_c = [tuple(int(v) for v in d) for d in offsets_c]
    r_c = max((max(abs(a), abs(b)) for a, b in offsets_c), default=0)
    q = 2 * r_c + 1
    Hc = -(-lv.reach // k) + 1
    loc_c = Wxc // mesh.n_sh if sharded else Wxc
    row0 = mesh.rank * loc_c if sharded else 0
    dev = lv.A.device

    # global coarse row / column indices of this rank's extended slab
    gx_ext = torch.arange(loc_c + 2 * Hc, device=dev)[:, None] + (row0 - Hc)
    gy = torch.arange(Wyc, device=dev)[None, :]
    real = (gx_ext >= 0) & (gx_ext < Wxc)  # probe points must be real coarse rows
    probes = []
    for a in range(q):
        for b in range(q):
            e_ext = ((gx_ext % q == a) & (gy % q == b) & real).to(lv.A.dtype)
            pe = _prolong_corr(lv, e_ext)  # P e
            # R (A (P e)): x = −Pe and b = 0 make the factored restriction's
            # residual b − A·x equal A·(P e)
            ts = _restrict(lv, -pe, torch.zeros_like(pe), mesh)
            probes.append(_subsample(ts, k))
    BC = torch.stack(probes)  # [q², loc_c, Wyc]

    gx = torch.arange(loc_c, device=dev)[:, None] + row0
    planes = []
    for du, dv in offsets_c:
        sel = ((gx + du) % q) * q + (gy + dv) % q  # the probe holding A_c[w, w + (du, dv)]
        planes.append(BC.gather(0, sel.expand(loc_c, Wyc)[None])[0])
    return torch.stack(planes)
