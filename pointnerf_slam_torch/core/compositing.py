"""Alpha compositing of raw field outputs along rays.

Last-interval distance 1e10, intervals scaled by ||rays_d||,
alpha = 1 - exp(-relu(sigma) * dist) (density mode) or sigmoid(10 * raw)
(occupancy mode), transmittance = exclusive cumprod of (1 - alpha + 1e-10),
depth variance = sum(w * (z - depth)^2).
"""

from __future__ import annotations

import torch


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor,
                rays_d: torch.Tensor, occupancy: bool = False):
    """raw (N, S, 4) RGBA, z_vals (N, S), rays_d (N, 3) ->
    depth (N,), depth_var (N,), rgb (N, 3), weights (N, S)."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if occupancy:
        alpha = torch.sigmoid(10.0 * raw[..., -1])
    else:
        alpha = 1.0 - torch.exp(-torch.relu(raw[..., -1]) * dists)
    trans = torch.cumprod(torch.cat(
        [torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1),
        -1)[..., :-1]
    weights = alpha * trans
    rgb = torch.sum(weights[..., None] * raw[..., :-1], dim=-2)
    depth = torch.sum(weights * z_vals, dim=-1)
    tmp = z_vals - depth[..., None]
    var = torch.sum(weights * tmp * tmp, dim=-1)
    return depth, var, rgb, weights
