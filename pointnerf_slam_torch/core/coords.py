"""Intrinsics matrix and coordinate normalisation into the scene bound
(the NICE feature grids' trilinear lookup takes [-1, 1]^3 points)."""

from __future__ import annotations

import numpy as np
import torch


def intrinsics_matrix(fx, fy, cx, cy) -> np.ndarray:
    """3x3 K from (fx, fy, cx, cy)."""
    K = np.eye(3)
    K[0, 0] = fx
    K[1, 1] = fy
    K[0, 2] = cx
    K[1, 2] = cy
    return K


def normalize_3d_coordinate(p: torch.Tensor, bound: torch.Tensor
                            ) -> torch.Tensor:
    """(..., 3) points mapped into [-1, 1]^3 over the AABB bound (3, 2)
    [[x0, x1], [y0, y1], [z0, z1]] (a new tensor; p is not changed)."""
    lo, hi = bound[:, 0], bound[:, 1]
    return (p - lo) / (hi - lo) * 2.0 - 1.0
