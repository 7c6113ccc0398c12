"""Differentiable volume renderer in plain torch (autograd end to end).

  - near = 0.01 * gt_depth; far = AABB exit clamped to 1.2 * max(gt_depth)
    over the WHOLE ray batch
  - N_samples stratified (linear in depth, or in disparity with lindisp;
    with perturb > 0 each sample moves inside its stratum by the caller's
    uniforms t_rand), plus N_surface samples in the [0.95, 1.05] * depth
    band (zero-depth rays sample 0.001 .. max depth instead), then
    N_importance inverse-CDF samples (deterministic u, or the caller's
    uniforms u_imp with perturb > 0) and a full re-evaluation at the
    merged, sorted z; N_importance 0 keeps the first pass
  - out-of-AABB points get density (occupancy) 100 (strict interior test)
  - occupancy mode composites alpha = sigmoid(10 * raw)
  - `regulation`: free-space density along [0, 0.85 * depth], stratified
    and perturbed by caller-drawn uniforms
  - `render_img`: the full H x W image in ray chunks under no_grad

The field is `decoder(points)` for the iMAP* decoder, or with c_grid
`decoder(points, c_grid, stage, bound)` for the NICE stack
(models.decoders.NICEDecoder). This is the math the fused kernels in ops/
are held against.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.compositing import raw2outputs
from ..core.sampling import (ray_far_bound, sample_pdf, stratified_zvals,
                             surface_zvals)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    N_samples: int = 32
    N_surface: int = 0
    N_importance: int = 12
    lindisp: bool = False
    perturb: float = 0.0
    occupancy: bool = False

    @classmethod
    def from_cfg(cls, cfg: dict) -> "RenderConfig":
        r = cfg["rendering"]
        return cls(N_samples=r["N_samples"], N_surface=r["N_surface"],
                   N_importance=r["N_importance"], lindisp=r["lindisp"],
                   perturb=r["perturb"], occupancy=cfg["occupancy"])


def clip_far(far_bb: torch.Tensor, gt_depth: torch.Tensor,
             depth_max: torch.Tensor | None = None) -> torch.Tensor:
    """clip(far_bb, 0, max(gt_depth * 1.2)); the max runs over the whole
    batch (every window frame in the mapper), on the device, or is taken
    as depth_max * 1.2 where the batch is one shard of a larger one
    (parallel.make_sharded_mapping_step)."""
    top = torch.max(gt_depth * 1.2) if depth_max is None \
        else depth_max * 1.2
    return torch.minimum(far_bb.clamp(min=0.0), top)


def eval_points(decoder, pts: torch.Tensor, bound: torch.Tensor,
                c_grid: dict | None = None, stage: str = "color"
                ) -> torch.Tensor:
    """(N, 3) points -> (N, 4) raw RGBA; density 100 outside the AABB.
    With (non-empty) c_grid the NICE field at `stage`."""
    raw = (decoder(pts, c_grid, stage, bound) if c_grid
           else decoder(pts))
    inside = ((pts > bound[:, 0]) & (pts < bound[:, 1])).all(dim=-1)
    sig = torch.where(inside, raw[:, 3], torch.full_like(raw[:, 3], 100.0))
    return torch.cat([raw[:, :3], sig[:, None]], dim=-1)


def _field(decoder, rays_o, rays_d, z, bound, c_grid=None, stage="color"):
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    return eval_points(decoder, pts.reshape(-1, 3), bound, c_grid,
                       stage).reshape(z.shape + (4,))


def render_rays(decoder, rcfg: RenderConfig, rays_o, rays_d, bound,
                gt_depth, with_zvals: bool = False, c_grid=None,
                stage: str = "color", t_rand=None, u_imp=None,
                depth_max=None):
    """Render (N,) rays guided by gt_depth (N,); with gt_depth None (a
    novel view, no depth prior) near is 0.01, far the AABB exit and there
    is no surface band. With rcfg.perturb > 0, t_rand (N, N_samples) and
    (when N_importance > 0) u_imp (N, N_importance) are the caller's
    uniforms. depth_max: max(gt_depth) of the whole batch when these rays
    are one shard of it (the far clip and the zero-depth surface band
    read it); None: this batch's.

    Returns depth (N,), depth_var (N,), color (N, 3), weights (N, S)
    [, z_vals (N, S), sigma (N, S) with with_zvals]."""
    if rcfg.perturb > 0 and (t_rand is None or (
            rcfg.N_importance > 0 and u_imp is None)):
        raise ValueError("perturb > 0 needs the caller's uniforms t_rand "
                         "(and u_imp with N_importance > 0)")
    far = ray_far_bound(rays_o, rays_d, bound)[:, None]
    if gt_depth is None:
        near = torch.full_like(far, 0.01)
    else:
        gt_depth = gt_depth.reshape(-1)
        near = (gt_depth * 0.01)[:, None]
        far = clip_far(far[:, 0], gt_depth, depth_max)[:, None]
    z = stratified_zvals(near, far, rcfg.N_samples,
                         t_rand if rcfg.perturb > 0 else None, rcfg.lindisp)
    if rcfg.N_surface > 0 and gt_depth is not None:
        z, _ = torch.sort(torch.cat(
            [z, surface_zvals(gt_depth, rcfg.N_surface, depth_max)],
            dim=-1), dim=-1)
    raw = _field(decoder, rays_o, rays_d, z, bound, c_grid, stage)
    depth, var, color, weights = raw2outputs(raw, z, rays_d, rcfg.occupancy)
    if rcfg.N_importance > 0:
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        z_s = sample_pdf(z_mid, weights[..., 1:-1], rcfg.N_importance,
                         u_imp if rcfg.perturb > 0 else None)
        z, _ = torch.sort(torch.cat([z, z_s], dim=-1), dim=-1)
        raw = _field(decoder, rays_o, rays_d, z, bound, c_grid, stage)
        depth, var, color, weights = raw2outputs(raw, z, rays_d,
                                                 rcfg.occupancy)
    if with_zvals:
        return depth, var, color, weights, z, raw[..., 3]
    return depth, var, color, weights


def render_img(decoder, rcfg: RenderConfig, H: int, W: int, fx, fy, cx, cy,
               c2w, bound, gt_depth=None, c_grid=None, stage: str = "color",
               chunk: int = 16384):
    """Depth (H, W), variance (H, W) and colour (H, W, 3) of the full image
    at c2w (4, 4) (or (3, 4)), rendered through render_rays in chunks of
    `chunk` rays in row-major pixel order, under no_grad. Each chunk is one
    batch of render_rays: with gt_depth (H, W) its far clip and the
    surface band of zero-depth rays take the chunk's max depth."""
    from ..core.rays import get_rays
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=bound.device)
    rays_o, rays_d = get_rays(H, W, fx, fy, cx, cy, c2w[:3])
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    gd = None
    if gt_depth is not None:
        gd = torch.as_tensor(gt_depth, dtype=torch.float32,
                             device=bound.device).reshape(-1)
    out = []
    with torch.no_grad():
        for i in range(0, rays_o.shape[0], chunk):
            sl = slice(i, i + chunk)
            out.append(render_rays(decoder, rcfg, rays_o[sl], rays_d[sl],
                                   bound, None if gd is None else gd[sl],
                                   c_grid=c_grid, stage=stage)[:3])
    depth, var, color = (torch.cat(t) for t in zip(*out))
    return depth.reshape(H, W), var.reshape(H, W), color.reshape(H, W, 3)


def regulation(decoder, rcfg: RenderConfig, rays_o, rays_d, gt_depth,
               bound, t_rand: torch.Tensor, c_grid=None,
               stage: str = "color") -> torch.Tensor:
    """Free-space densities at N_samples perturbed z in [0, 0.85 * depth]
    per ray; t_rand (N, N_samples) are the caller's uniforms.
    Returns (N * N_samples,)."""
    d = gt_depth.reshape(-1, 1)
    z = stratified_zvals(torch.zeros_like(d), d * 0.85, rcfg.N_samples,
                         t_rand)
    return _field(decoder, rays_o, rays_d, z, bound, c_grid,
                  stage)[..., 3].reshape(-1)
