"""K7: one multicolor GS/SOR smoother application on a 3-D LatND level.

Port of the JAX package's ``ops/pallas/sweep3d_kernel.py``
(``_sweep3d_kernel`` via ``smooth_sweep3d``).  The JAX package keeps it
opt-in (``AMG_SWEEP3D=1``) because its TPU compiler crashed on the kernel;
its semantics are pinned to the masked sweep, and the port makes it the
default smoother of every 3-D LatND level with no zero diagonal and a
periodic coloring (``models/device.py``).  The TPU gates on ``nz % 128``
and on the VMEM budget are its layout and are not ported; the port's own
shape limit is ``tiled_sweep.plan_box``.  The CUDA kernel
(``csrc/sweep3d.cu`` on ``csrc/sweep_tile.cuh``) tiles all three axes and
reads the LatND planes, x, b and D⁻¹ in place — no second, halo-padded copy
of the planes and no color field — one launch per application.
``smooth_sweep3d`` launches it on a CUDA tensor and runs the plain version
(the step-by-step masked sweep, ``tiled_sweep.tiled_sweep_reference``) on a
CPU tensor.
"""

from __future__ import annotations

from typing import Optional

from .tiled_sweep import TiledSweepCache, launch_tiled_sweep, tiled_sweep_cache, tiled_sweep_reference

__all__ = ["Sweep3DCache", "build_sweep3d_cache", "smooth_sweep3d", "smooth_sweep3d_reference"]


class Sweep3DCache(TiledSweepCache):
    """K7's cache: a 3-D LatND level, its 1/diag and its periodic coloring."""


def build_sweep3d_cache(A, dinv, color_table, n_colors, omega, iters, fwd, bwd, fallback=None) -> Optional[Sweep3DCache]:
    """K7 for a square 3-D LatND level ``A`` with 1/diag ``dinv``
    [rows_padded] and the ``lattice_coloring_nd`` table ``color_table``;
    None (logged) past the kernel's shape limits.  ``fallback``, the
    level's masked multicolor cache, runs a multi-RHS x."""
    if len(A.row_dims) != 3 or any(tuple(b) != (1, 1) for b in A.bases):
        raise ValueError("K7 smooths square 3-D LatND levels")
    return tiled_sweep_cache(Sweep3DCache, A, dinv, color_table, n_colors, omega, iters, fwd, bwd, fallback)


def smooth_sweep3d_reference(cache: Sweep3DCache, x, b):
    """K7's plain version: the masked sweep over the color steps."""
    return tiled_sweep_reference(cache, x, b)


def smooth_sweep3d(cache: Sweep3DCache, x, b):
    """One smoother application to flat padded x, b; returns a new x."""
    return launch_tiled_sweep(cache, x, b, "sweep3d", "sweep3d")
