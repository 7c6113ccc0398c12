"""Pseudo-depth map splatting (the JAX reference's frontend/pseudo_depth.py):
each triangulated keypoint writes its depth into the [c - p, c + p) rows
and columns around its pixel; a keypoint whose full patch would cross the
border writes only its own pixel.

Where two writes land on one pixel the later keypoint wins (the reference's
scatter applies its updates in order on the CPU); here the winner is picked
by a max over write order, so the result is the same on every device."""

from __future__ import annotations

import torch


def splat_pseudo_depth(uv: torch.Tensor, depth: torch.Tensor,
                       valid: torch.Tensor, H: int, W: int,
                       patch: int = 5) -> torch.Tensor:
    """uv (K, 2) pixel coords (u = column), depth (K,), valid (K,) ->
    (H, W) float32 map, 0 where nothing landed."""
    dev = uv.device
    u, v = uv[:, 0], uv[:, 1]
    full_ok = (v - patch > 0) & (u - patch > 0) & (v + patch < H) \
        & (u + patch < W)
    center_ok = (v > 0) & (u > 0) & (v < H) & (u < W)
    off = torch.arange(-patch, patch, device=dev)
    ov, ou = torch.meshgrid(off, off, indexing="ij")
    ov, ou = ov.reshape(-1), ou.reshape(-1)
    vv = v[:, None].to(torch.int64) + ov[None, :]
    uu = u[:, None].to(torch.int64) + ou[None, :]
    center = (ov == 0) & (ou == 0)
    write = valid[:, None] & (full_ok[:, None]
                              | (center_ok[:, None] & center[None, :]))
    flat = (vv.clamp(0, H - 1) * W + uu.clamp(0, W - 1)).reshape(-1)
    flat = torch.where(write.reshape(-1), flat, torch.full_like(flat, H * W))
    order = torch.arange(flat.shape[0], device=dev)
    win = torch.full((H * W + 1,), -1, dtype=torch.int64, device=dev)
    win = win.scatter_reduce(0, flat, order, reduce="amax")[:H * W]
    vals = depth.to(torch.float32)[:, None].expand(-1, ov.shape[0])
    vals = vals.reshape(-1)
    out = torch.where(win >= 0, vals[win.clamp(min=0)],
                      torch.zeros((), device=dev))
    return out.reshape(H, W)
