"""Trilinear sampling of a channel-last 3-D feature grid (the NICE stack's
feature lookup).

Semantics of torch.nn.functional.grid_sample(mode='bilinear',
padding_mode='border', align_corners=True) on a 3-D grid, in the JAX
reference's layout:
  - a normalised coordinate x in [-1, 1] maps to voxel index
    (x + 1) / 2 * (D - 1);
  - out-of-range coordinates clamp to the border voxel;
  - grids are channel-last (Dx, Dy, Dz, C), and a point's (x, y, z) index
    (Dx, Dy, Dz) in that order (F.grid_sample would read them reversed).
Plain torch ops: eight corner gathers and the lerp chain in the
reference's order, differentiable in both the grid and the points.
"""

from __future__ import annotations

import torch


def trilinear_sample(grid: torch.Tensor, p_nor: torch.Tensor) -> torch.Tensor:
    """grid (Dx, Dy, Dz, C) at points p_nor (N, 3) in [-1, 1]^3 -> (N, C)."""
    Dx, Dy, Dz, _ = grid.shape
    dims = torch.tensor([Dx, Dy, Dz], dtype=p_nor.dtype,
                        device=p_nor.device)
    idx = (p_nor + 1.0) * 0.5 * (dims - 1.0)
    idx = torch.minimum(idx.clamp(min=0.0), dims - 1.0)
    i0f = torch.floor(idx)
    frac = idx - i0f
    top = torch.tensor([Dx - 1, Dy - 1, Dz - 1], device=p_nor.device)
    # clamped as the reference's gathers clamp (a NaN point reads a cell
    # and gives NaN, as there, instead of an out-of-range index)
    i0 = torch.minimum(i0f.to(torch.int64).clamp(min=0), top)
    i1 = torch.minimum(i0 + 1, top)
    x0, y0, z0 = i0.unbind(-1)
    x1, y1, z1 = i1.unbind(-1)
    fx, fy, fz = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]
    g = grid
    c00 = g[x0, y0, z0] * (1 - fz) + g[x0, y0, z1] * fz
    c01 = g[x0, y1, z0] * (1 - fz) + g[x0, y1, z1] * fz
    c10 = g[x1, y0, z0] * (1 - fz) + g[x1, y0, z1] * fz
    c11 = g[x1, y1, z0] * (1 - fz) + g[x1, y1, z1] * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx
