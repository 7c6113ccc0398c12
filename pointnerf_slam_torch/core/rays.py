"""Ray generation and static-budget pixel sampling.

Pixel (i, j) maps to the camera ray direction [(i-cx)/fx, -(j-cy)/fy, -1]
(camera looks down -z, +y up), rotated into the world by c2w[:3, :3].

Every sampler takes a `torch.Generator`; callers that replay draws made
elsewhere skip the sampler and pass the indices on (engine/state.py Draws).
"""

from __future__ import annotations

import torch


def ray_dirs_from_uv(i, j, fx, fy, cx, cy) -> torch.Tensor:
    """Pixel coords (i=column, j=row) -> camera-frame directions (..., 3)."""
    return torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)],
                       dim=-1)


def rays_from_uv(i, j, c2w, fx, fy, cx, cy):
    """Rays for pixel coords under pose c2w (..., 3, 4); differentiable in
    c2w. Returns rays_o, rays_d (..., 3); rays_d is not normalised."""
    dirs = ray_dirs_from_uv(i, j, fx, fy, cx, cy)
    R = c2w[..., :3, :3]
    rays_d = torch.einsum("...ij,...j->...i", R, dirs)
    rays_o = c2w[..., :3, 3].expand_as(rays_d)
    return rays_o, rays_d


def get_rays(H: int, W: int, fx, fy, cx, cy, c2w):
    """Rays of the full image, (H, W, 3) each, under pose c2w (3, 4)."""
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=c2w.device),
        torch.arange(W, dtype=torch.float32, device=c2w.device),
        indexing="ij")
    return rays_from_uv(i, j, c2w, fx, fy, cx, cy)


def sample_uv_uniform(gen: torch.Generator, W: int, H0: int, H1: int,
                      W0: int, W1: int, n: int) -> torch.Tensor:
    """n flat full-image indices, uniform with replacement over the crop
    [H0, H1) x [W0, W1). `W` is the full image width (row-major)."""
    w = W1 - W0
    flat = torch.randint(0, (H1 - H0) * w, (n,), generator=gen,
                         device=gen.device)
    return (flat // w + H0) * W + flat % w + W0


def sample_uv_valid(gen: torch.Generator, valid_mask: torch.Tensor,
                    n: int):
    """n flat indices uniform with replacement over the True entries of
    valid_mask (uniform over the whole image if none is True).

    Count-CDF + searchsorted: one O(HW) cumsum and an O(n log HW) search
    instead of a categorical over HW logits. Returns (indices, n_valid)."""
    m = valid_mask.reshape(-1)
    n_valid = m.sum()
    # drawn on the generator's device, used on the mask's
    u = torch.rand((n,), generator=gen, device=gen.device).to(m.device)
    r = (u * n_valid.clamp(min=1)).to(torch.int64).clamp(
        max=int(m.shape[0]) - 1)
    idx_any = torch.randint(0, m.shape[0], (n,), generator=gen,
                            device=gen.device).to(m.device)
    return valid_index_of_rank(m, r, idx_any), n_valid


def valid_index_of_rank(valid_mask: torch.Tensor, rank: torch.Tensor,
                        idx_any: torch.Tensor) -> torch.Tensor:
    """Flat index of the (rank+1)-th True entry of valid_mask: the first
    i with cum[i] > rank on the inclusive count-CDF. Returns idx_any where
    the mask has no True entry."""
    cum = torch.cumsum(valid_mask.reshape(-1).to(torch.int64), 0)
    idx = torch.searchsorted(cum, rank, right=True)
    return torch.where(cum[-1] > 0, idx, idx_any)


def gather_pixels(flat_idx: torch.Tensor, W: int, depth: torch.Tensor,
                  color: torch.Tensor):
    """(i, j, depth, color) at flat row-major pixel indices."""
    ii = (flat_idx % W).to(torch.float32)
    jj = torch.div(flat_idx, W, rounding_mode="floor").to(torch.float32)
    d = depth.reshape(-1)[flat_idx]
    c = color.reshape(-1, 3)[flat_idx]
    return ii, jj, d, c
