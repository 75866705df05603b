"""K5: one multicolor GS/SOR smoother application on a Lat2D level.

Port of the JAX package's ``ops/pallas/gs_kernel.py`` (``_sweep_kernel``
via ``smooth_pallas_gs``).  The JAX package runs it on every Lat2D level
that has neither fused legs nor a place in the whole-tail kernel, when no
cell has a zero diagonal; so does the port (``models/device.py``).  The TPU
kernel's pre-tiled planes with duplicated halos and its per-call re-tiling
of x and b are its VMEM layout and are not ported: the CUDA kernel
(``csrc/gs_sweep.cu``) reads the level's planes, x, b and D⁻¹ in place, one
launch per application.  It is the march of K7 (``csrc/sweep_march.cuh``)
on the level as the grid (Wx, 1, Wy): a block walks a strip of rows
(``tiled_sweep.plan_march``, ``MARCH_STRIP``) over a segment, each row's x
landing once in a ring in shared memory; a level past its limits keeps the
masked sweep.  ``smooth_gs`` launches it on a CUDA tensor and runs the
plain version (the step-by-step masked sweep,
``tiled_sweep.tiled_sweep_reference``) on a CPU tensor.  ``smooth_gs_tile``
runs K5's first design, the halo-tile kernel (``csrc/sweep_tile.cuh``),
which the march replaced: it is the comparison that ``chip_smoke.py`` and
the card tests hold the march against.
"""

from __future__ import annotations

from typing import Optional

from .tiled_sweep import TiledSweepCache, launch_tiled_sweep, tile_view, tiled_sweep_cache, tiled_sweep_reference

__all__ = ["GSSweepCache", "build_gs_sweep_cache", "smooth_gs", "smooth_gs_reference", "smooth_gs_tile"]


class GSSweepCache(TiledSweepCache):
    """K5's cache: a Lat2D level, its 1/diag and its periodic coloring."""


def build_gs_sweep_cache(A, dinv, color_grid, n_colors, omega, iters, fwd, bwd, fallback=None) -> Optional[GSSweepCache]:
    """K5 for a Lat2D level ``A`` with 1/diag ``dinv`` [rows_padded] and
    the ``lattice_coloring`` table ``color_grid``; None (logged) past the
    kernel's shape limits.  ``fallback``, the level's masked multicolor
    cache, runs a multi-RHS x."""
    return tiled_sweep_cache(GSSweepCache, A, dinv, color_grid, n_colors, omega, iters, fwd, bwd, fallback)


def smooth_gs_reference(cache: GSSweepCache, x, b):
    """K5's plain version: the masked sweep over the color steps."""
    return tiled_sweep_reference(cache, x, b)


def smooth_gs(cache: GSSweepCache, x, b):
    """One smoother application to flat padded x, b; returns a new x."""
    return launch_tiled_sweep(cache, x, b, "gs_sweep", "gs")


def smooth_gs_tile(cache: GSSweepCache, x, b):
    """The same application by K5's first design, the halo-tile kernel, on
    the box ``plan_box`` gives the level (counted as a K5 launch)."""
    return launch_tiled_sweep(tile_view(cache), x, b, "gs_sweep", "gs")
