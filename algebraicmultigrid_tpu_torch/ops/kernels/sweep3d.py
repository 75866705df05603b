"""K7: one multicolor GS/SOR smoother application on a 3-D LatND level.

Port of the JAX package's ``ops/pallas/sweep3d_kernel.py``
(``_sweep3d_kernel`` via ``smooth_sweep3d``).  The JAX package keeps it
opt-in (``AMG_SWEEP3D=1``) because its TPU compiler crashed on the kernel;
its semantics are pinned to the masked sweep, and the port makes it the
default smoother of every 3-D LatND level with no zero diagonal and a
periodic coloring (``models/device.py``).  The TPU gates on ``nz % 128``
and on the VMEM budget are its layout and are not ported.  Like the TPU
kernel, the CUDA kernel (``csrc/sweep3d.cu``) marches along axis 0: a
block walks a y-z column (tile plus halo) over a segment of planes, each
plane's x landing once in a ring in shared memory, the color steps a
wavefront a reach behind each other (``csrc/sweep_march.cuh``, planned by
``tiled_sweep.plan_march``); a level past its limits keeps the masked
sweep.  One launch per application.  ``smooth_sweep3d`` launches it on a
CUDA tensor and runs the plain version (the step-by-step masked sweep,
``tiled_sweep.tiled_sweep_reference``) on a CPU tensor.
``smooth_sweep3d_tile`` runs K7's first design, the halo-tile kernel
(``csrc/sweep_tile.cuh``), which the march replaced: it is the comparison
that ``chip_smoke.py`` and the card tests hold the march against.
"""

from __future__ import annotations

from typing import Optional

from .tiled_sweep import TiledSweepCache, launch_tiled_sweep, tile_view, tiled_sweep_cache, tiled_sweep_reference

__all__ = ["Sweep3DCache", "build_sweep3d_cache", "smooth_sweep3d", "smooth_sweep3d_reference", "smooth_sweep3d_tile"]


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


def smooth_sweep3d_tile(cache: Sweep3DCache, x, b):
    """The same application by K7's first design, the halo-tile kernel, on
    the box ``plan_box`` gives the level (counted as a K7 launch)."""
    return launch_tiled_sweep(tile_view(cache), x, b, "sweep3d", "sweep3d")
