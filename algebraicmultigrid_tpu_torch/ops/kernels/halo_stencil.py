"""K8: the Lat2D stencil on one x-slab, in an interior and a boundary part.

Port of the kernel of the JAX package's ``parallel/async_halo.py``
(``lat2d_spmv_halo_async``; its row helper ``_stencil_rows``).  A rank
holding grid rows [r0, r0 + loc) computes

    y[i, j] = Σ_k data[k, i, j] · X[i + dx_k, j + dy_k]

with X its slab ``x`` [loc, Wy], the ``halo`` [2, reach, Wy] rows of its
neighbours above (``halo[0]``) and below (``halo[1]``) the slab, and 0
beyond the grid's columns; ``reach`` = max |dx|.  ``"interior"`` computes
the rows [reach, loc − reach), which read x only, so they can run while the
halo is in flight; ``"boundary"`` the ``reach`` top and bottom rows, which
read the halo (None reads zeros, a chain end or a single slab).
``parallel/async_halo.py`` runs the two parts around the exchange.

``halo_stencil`` launches the CUDA kernel (``csrc/halo_stencil.cu``, a
thread per cell) on a CUDA tensor, counted under ``launches["halo"]``, and
runs ``halo_stencil_reference`` — the ``_stencil_rows`` sum on the
halo-padded slab — on a CPU tensor.  A part with no rows (the interior of a
slab of exactly 2·reach rows) launches nothing.  The kernel rounds each
product and sum as the plain version does, so the two agree bitwise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .vcycle_legs import MAX_OFFSETS, SUFFIX, _ints, _stream, launches, load_library, raise_on

__all__ = ["halo_stencil", "halo_stencil_reference", "stencil_reach", "PARTS"]

PARTS = {"interior": 0, "boundary": 1}


def stencil_reach(offsets) -> Tuple[int, int]:
    """(reach along x, reach along y) of a stencil's offsets."""
    return (max((abs(dx) for dx, _ in offsets), default=0), max((abs(dy) for _, dy in offsets), default=0))


def _row_ranges(part: str, loc: int, reach: int):
    if part == "interior":
        return [(reach, loc - 2 * reach)]
    return [(0, reach), (loc - reach, reach)]


def _stencil_rows(data, Xp, offsets, reach, my, r0, nrows, Wy):
    """y rows [r0, r0 + nrows) of the stencil on the halo-padded slab ``Xp``
    ([loc + 2·reach, Wy + 2·my]); ``data`` is the [n_off, loc, Wy] slab."""
    acc = None
    for k, (dx, dy) in enumerate(offsets):
        src = Xp[r0 + reach + dx : r0 + reach + dx + nrows, my + dy : my + dy + Wy]
        term = data[k, r0 : r0 + nrows] * src
        acc = term if acc is None else acc + term
    return acc


def _check(data, x, halo, offsets, part, out):
    if part not in PARTS:
        raise ValueError(f"part is 'interior' or 'boundary', not {part!r}")
    if x.dim() != 2 or data.dim() != 3 or data.shape[1:] != x.shape or data.shape[0] != len(offsets):
        raise ValueError(f"planes {tuple(data.shape)} and slab {tuple(x.shape)} do not match {len(offsets)} offsets")
    loc, Wy = x.shape
    reach, _ = stencil_reach(offsets)
    if loc < 2 * reach:
        raise ValueError(f"a slab of {loc} rows is thinner than twice the stencil's reach {reach}")
    for name, t in (("planes", data), ("halo", halo), ("out", out)):
        if t is None:
            continue
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, the slab {x.dtype} on {x.device}")
    if halo is not None and tuple(halo.shape) != (2, reach, Wy):
        raise ValueError(f"the halo must be [2, {reach}, {Wy}], got {tuple(halo.shape)}")
    if out is not None and tuple(out.shape) != (loc, Wy):
        raise ValueError(f"out must be [{loc}, {Wy}], got {tuple(out.shape)}")
    return loc, Wy, reach


def halo_stencil_reference(data, x, halo, offsets: Sequence[Tuple[int, int]], part: str, out=None):
    """The rows of ``part`` in plain PyTorch, written into ``out`` [loc, Wy]
    (allocated when None), which is returned."""
    loc, Wy, reach = _check(data, x, halo, offsets, part, out)
    my = stencil_reach(offsets)[1]
    if out is None:
        out = torch.empty_like(x)
    hal = halo if halo is not None else x.new_zeros((2, reach, Wy))
    Xp = torch.nn.functional.pad(torch.cat([hal[0], x, hal[1]], dim=0), (my, my))
    for r0, nrows in _row_ranges(part, loc, reach):
        if nrows > 0:
            out[r0 : r0 + nrows] = _stencil_rows(data, Xp, offsets, reach, my, r0, nrows, Wy)
    return out


def halo_stencil(data, x, halo: Optional[torch.Tensor], offsets, part: str, out=None):
    """The rows of ``part`` of y = A·x on a slab, written into ``out``
    (allocated when None) and returned: the CUDA kernel on the current
    stream for a CUDA tensor, the plain version for a CPU tensor.  ``data``
    may be a row slab of larger planes (unit column stride, rows ``Wy``
    apart); it is read in place."""
    if x.device.type == "cpu":
        return halo_stencil_reference(data, x, halo, offsets, part, out)
    if x.device.type != "cuda":
        raise ValueError(f"halo_stencil runs on cuda or cpu tensors, not {x.device}")
    loc, Wy, reach = _check(data, x, halo, offsets, part, out)
    if x.dtype not in SUFFIX:
        raise TypeError(f"halo_stencil takes float32 or float64, not {x.dtype}")
    if len(offsets) > MAX_OFFSETS:
        raise ValueError(f"{len(offsets)} offsets (the kernel takes {MAX_OFFSETS})")
    if data.stride(2) != 1 or data.stride(1) != Wy:
        raise ValueError(f"the planes must have unit column stride and rows {Wy} apart, got {data.stride()}")
    if not x.is_contiguous() or (halo is not None and not halo.is_contiguous()):
        raise ValueError("the slab and the halo must be contiguous")
    if out is None:
        out = torch.empty_like(x)
    elif not out.is_contiguous():
        raise ValueError("out must be contiguous")
    rows = loc - 2 * reach if part == "interior" else 2 * reach
    fn = getattr(load_library(), f"amg_halo_stencil_{SUFFIX[x.dtype]}")
    err = fn(
        out.data_ptr(), data.data_ptr(), data.stride(0), x.data_ptr(),
        None if halo is None else halo.data_ptr(), _ints([v for o in offsets for v in o]), len(offsets),
        loc, Wy, reach, PARTS[part], _stream(x),
    )
    raise_on(err, "halo_stencil kernel")
    if rows * Wy > 0:
        launches["halo"] += 1
    return out

