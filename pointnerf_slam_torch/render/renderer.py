"""Differentiable volume renderer in plain torch (autograd end to end).

  - near = 0.01 * gt_depth; far = AABB exit clamped to 1.2 * max(gt_depth)
    over the WHOLE ray batch
  - N_samples stratified, N_importance deterministic inverse-CDF samples,
    full re-evaluation at the merged, sorted z
  - out-of-AABB points get density 100 (strict interior test)
  - `regulation`: free-space density along [0, 0.85 * depth], stratified
    and perturbed by caller-drawn uniforms

This is the math the fused kernels in ops/ are held against.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.compositing import raw2outputs
from ..core.sampling import ray_far_bound, sample_pdf, stratified_zvals


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

    def check_supported(self):
        if (self.N_surface or self.lindisp or self.perturb
                or self.occupancy or self.N_importance <= 0):
            raise NotImplementedError(
                f"the port renders only the iMAP* flagship sampling "
                f"(no surface band, no lindisp, perturb 0, density mode, "
                f"N_importance > 0); got {self}")


def clip_far(far_bb: torch.Tensor, gt_depth: torch.Tensor) -> torch.Tensor:
    """clip(far_bb, 0, max(gt_depth * 1.2)); the max runs over the whole
    batch (every window frame in the mapper), on the device."""
    return torch.minimum(far_bb.clamp(min=0.0), torch.max(gt_depth * 1.2))


def eval_points(decoder, pts: torch.Tensor, bound: torch.Tensor
                ) -> torch.Tensor:
    """(N, 3) points -> (N, 4) raw RGBA; density 100 outside the AABB."""
    raw = decoder(pts)
    inside = ((pts > bound[:, 0]) & (pts < bound[:, 1])).all(dim=-1)
    sig = torch.where(inside, raw[:, 3], torch.full_like(raw[:, 3], 100.0))
    return torch.cat([raw[:, :3], sig[:, None]], dim=-1)


def _field(decoder, rays_o, rays_d, z, bound):
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    return eval_points(decoder, pts.reshape(-1, 3), bound).reshape(
        z.shape + (4,))


def render_rays(decoder, rcfg: RenderConfig, rays_o, rays_d, bound,
                gt_depth, with_zvals: bool = False):
    """Render (N,) rays guided by gt_depth (N,); with gt_depth None (a
    novel view, no depth prior) near is 0.01 and far the AABB exit.

    Returns depth (N,), depth_var (N,), color (N, 3), weights (N, S)
    [, z_vals (N, S), sigma (N, S) with with_zvals]."""
    rcfg.check_supported()
    far = ray_far_bound(rays_o, rays_d, bound)[:, None]
    if gt_depth is None:
        near = torch.full_like(far, 0.01)
    else:
        gt_depth = gt_depth.reshape(-1)
        near = (gt_depth * 0.01)[:, None]
        far = clip_far(far[:, 0], gt_depth)[:, None]
    z = stratified_zvals(near, far, rcfg.N_samples)
    raw1 = _field(decoder, rays_o, rays_d, z, bound)
    _, _, _, w1 = raw2outputs(raw1, z, rays_d)
    z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
    z_s = sample_pdf(z_mid, w1[..., 1:-1], rcfg.N_importance)
    z2, _ = torch.sort(torch.cat([z, z_s], dim=-1), dim=-1)
    raw = _field(decoder, rays_o, rays_d, z2, bound)
    depth, var, color, weights = raw2outputs(raw, z2, rays_d)
    if with_zvals:
        return depth, var, color, weights, z2, raw[..., 3]
    return depth, var, color, weights


def regulation(decoder, rcfg: RenderConfig, rays_o, rays_d, gt_depth,
               bound, t_rand: torch.Tensor) -> torch.Tensor:
    """Free-space densities at N_samples perturbed z in [0, 0.85 * depth]
    per ray; t_rand (N, N_samples) are the caller's uniforms.
    Returns (N * N_samples,)."""
    d = gt_depth.reshape(-1, 1)
    z = stratified_zvals(torch.zeros_like(d), d * 0.85, rcfg.N_samples,
                         t_rand)
    return _field(decoder, rays_o, rays_d, z, bound)[..., 3].reshape(-1)
