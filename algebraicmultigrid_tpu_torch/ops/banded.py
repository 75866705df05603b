"""Operator dispatch for the device tier.

The JAX package lowers levels to SDIA, BT, Dense, ELL, BSG, Lat2D or LatND.
This package lowers lattice levels only, so ``mat_vec`` dispatches Lat2D and
raises on anything else.
"""

from __future__ import annotations

import torch

from .lattice_op import Lat2D, lat2d_spmv

__all__ = ["mat_vec"]


def mat_vec(A, x: torch.Tensor) -> torch.Tensor:
    """SpMV over the device operator formats (Lat2D only)."""
    if isinstance(A, Lat2D):
        return lat2d_spmv(A, x)
    raise TypeError(f"unsupported device operator format {type(A).__name__}")
