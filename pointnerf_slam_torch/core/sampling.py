"""Depth sampling along rays: far bound, stratified, surface band and
inverse-CDF."""

from __future__ import annotations

import torch


def ray_far_bound(rays_o: torch.Tensor, rays_d: torch.Tensor,
                  bound: torch.Tensor) -> torch.Tensor:
    """Per-ray exit distance from the AABB `bound` (3, 2), + 0.01.

    Slab test: t = (bound - o) / d per axis, max over the two slab ends,
    min over axes. No gradient (detached inputs)."""
    o = rays_o.detach()[..., None]                  # (N, 3, 1)
    d = rays_d.detach()[..., None]
    d = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t = (bound[None] - o) / d                       # (N, 3, 2)
    return t.amax(dim=2).amin(dim=1) + 0.01


def stratified_zvals(near: torch.Tensor, far: torch.Tensor, n: int,
                     t_rand: torch.Tensor | None = None,
                     lindisp: bool = False) -> torch.Tensor:
    """(N, n) z linearly spaced in [near, far] (each broadcast to (N, 1)),
    or linearly in disparity with lindisp.

    With t_rand (N, n) uniforms, each sample is perturbed inside its
    stratum [lower, upper] (the caller draws t_rand)."""
    t_vals = torch.linspace(0.0, 1.0, n, device=near.device)
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        z = near * (1.0 - t_vals) + far * t_vals
    if t_rand is not None:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        z = lower + (upper - lower) * t_rand
    return z


def surface_zvals(gt_depth: torch.Tensor, n: int,
                  depth_max: torch.Tensor | None = None) -> torch.Tensor:
    """(N, n) z in the surface band around each ray's depth (N,):
    linspace over [0.95 d, 1.05 d] where d > 0, else over [0.001,
    max(gt_depth)] (the max runs over the whole batch, or is depth_max
    where given)."""
    t = torch.linspace(0.0, 1.0, n, device=gt_depth.device)
    d = gt_depth[..., None]
    z_surf = 0.95 * d * (1.0 - t) + 1.05 * d * t
    top = torch.max(gt_depth) if depth_max is None else depth_max
    z_zero = 0.001 * (1.0 - t) + top * t
    return torch.where(d > 0, z_surf, z_zero[None])


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n: int,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-CDF sampling at u = linspace(0, 1, n), or at the caller's
    uniforms u (N, n).

    bins (N, M) edges, weights (N, M-1) -> (N, n) z, no gradient."""
    w = weights.detach() + 1e-5
    pdf = w / w.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    M = cdf.shape[-1]
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=bins.device).expand(
            cdf.shape[:-1] + (n,))
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=M - 1)
    cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_b, bins_a = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return (bins_b + t * (bins_a - bins_b)).detach()
