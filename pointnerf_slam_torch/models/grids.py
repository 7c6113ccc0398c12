"""The NICE feature grids and their frustum masks.

init_grids: one feature grid per level (coarse, middle, fine, colour),
channel-last (Dx, Dy, Dz, c_dim) as the trilinear sampler and the
checkpoints hold them, each side ceil(extent * scale / grid_len) + 1 nodes
(the coarse level's extent enlarged by model.coarse_bound_enlarge), values
0.01 * N(0, 1) drawn from the caller's generator.

make_frustum_mask_fn: which cells of a level the current frame may
update. A cell is optimisable iff its centre projects inside the image,
lies in front of the camera and passes -z <= depth(u, v) + 0.5 (bilinear
depth lookup, zero outside the image, zero samples replaced by the
largest sampled depth), or lies within 0.5 (scaled) of the camera centre.
The coarse grid is never masked: callers give it all ones.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def grid_shapes(cfg: dict, bound) -> dict:
    """{grid name: (Dx, Dy, Dz)} of the configured levels, in the order the
    reference draws them."""
    lengths = np.asarray(bound)[:, 1] - np.asarray(bound)[:, 0]

    def shape_for(grid_len, scale=1):
        return tuple(int(math.ceil(l * scale / grid_len)) + 1
                     for l in lengths)

    gl = cfg["grid_len"]
    levels = {}
    if cfg["coarse"]:
        levels["grid_coarse"] = shape_for(
            gl["coarse"], cfg["model"]["coarse_bound_enlarge"])
    for name in ("middle", "fine", "color"):
        levels[f"grid_{name}"] = shape_for(gl[name])
    return levels


def init_grids(generator: torch.Generator, cfg: dict, bound,
               device=None) -> dict:
    """{'grid_coarse': (Dx, Dy, Dz, C), 'grid_middle': ..., ...} for the
    scaled scene bound (3, 2); values 0.01 * N(0, 1) from `generator`,
    moved to `device`."""
    c_dim = cfg["model"]["c_dim"]
    return {name: (0.01 * torch.randn(shape + (c_dim,),
                                      generator=generator,
                                      device=generator.device)).to(device)
            for name, shape in grid_shapes(cfg, bound).items()}


def _linspace(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """n points from lo to hi as jnp.linspace rounds them in float32:
    lo * (1 - t) + hi * t at t = k / (n - 1), the last exactly hi."""
    t = torch.arange(n - 1, dtype=torch.float32, device=lo.device) / (n - 1)
    return torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])


def make_frustum_mask_fn(shape, H: int, W: int, fx, fy, cx, cy):
    """fn(bound (3, 2), c2w (4, 4), depth (H, W)) -> (Dx, Dy, Dz, 1)
    float32 mask of one level of spatial shape (Dx, Dy, Dz)."""
    Dx, Dy, Dz = shape

    def mask_fn(bound, c2w, depth):
        axes = [_linspace(bound[k, 0], bound[k, 1], n)
                for k, n in enumerate((Dx, Dy, Dz))]
        gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
        pts = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
        w2c = torch.linalg.inv(c2w)
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        z = cam[:, 2] + 1e-5
        u = (fx * (-cam[:, 0]) + cx * z) / z
        v = (fy * cam[:, 1] + cy * z) / z
        u0, v0 = torch.floor(u), torch.floor(v)
        fu, fv = u - u0, v - v0
        u0i, v0i = u0.to(torch.int64), v0.to(torch.int64)
        flat = depth.reshape(-1)

        def tap(vi, ui):
            ok = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
            i = vi.clamp(0, H - 1) * W + ui.clamp(0, W - 1)
            return torch.where(ok, flat[i], torch.zeros_like(u))

        d = (tap(v0i, u0i) * (1 - fu) * (1 - fv)
             + tap(v0i, u0i + 1) * fu * (1 - fv)
             + tap(v0i + 1, u0i) * (1 - fu) * fv
             + tap(v0i + 1, u0i + 1) * fu * fv)
        d = torch.where(d == 0, d.max(), d)
        in_img = (u > 0) & (u < W) & (v > 0) & (v < H)
        mask = in_img & (-z >= 0) & (-z <= d + 0.5)
        dist2 = ((pts - c2w[:3, 3]) ** 2).sum(1)
        mask = mask | (dist2 < 0.25)
        return mask.to(torch.float32).reshape(Dx, Dy, Dz, 1)

    return mask_fn
