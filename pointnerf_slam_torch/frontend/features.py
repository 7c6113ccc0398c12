"""Keypoint detection and description on the device (the JAX reference's
frontend/features.py), behind `extract(gray) -> (kps, desc, valid, angles)`:

  - `HarrisExtractor`: Harris corners with max-pool non-maximum
    suppression, a static top-K with validity, quadratic sub-pixel
    refinement, 11x11 normalized-patch descriptors and ORB-style
    intensity-centroid orientations.
  - `SuperPointExtractor`: not ported (ROADMAP Queue 1 item 11); it raises.

The top-K is a stable descending sort, so equal scores keep the lower flat
index first (jax.lax.top_k's order; torch.topk promises none).
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

SUPERPOINT_TODO = ("the SuperPoint extractor is not ported (ROADMAP Queue 1 "
                   "item 11); set superpoint_weights: none for Harris")


def _maxpool_nms(score: torch.Tensor, radius: int) -> torch.Tensor:
    """Local maxima within a (2r+1)^2 window (padding counts as -inf)."""
    pooled = Fn.max_pool2d(score[None, None], 2 * radius + 1, stride=1,
                           padding=radius)[0, 0]
    return score == pooled


def _topk_keypoints(score: torch.Tensor, k: int, border: int,
                    min_conf: float, rel_conf: float = 0.0):
    """Top-k (x, y) keypoints of a score map; valid where the score
    exceeds max(min_conf, rel_conf * strongest)."""
    H, W = score.shape
    dev = score.device
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    ok = (yy >= border) & (yy < H - border) & (xx >= border) \
        & (xx < W - border)
    s = torch.where(ok, score, torch.full_like(score, -float("inf")))
    vals, idx = torch.sort(s.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    kps = torch.stack([(idx % W).to(torch.float32),
                       torch.div(idx, W, rounding_mode="floor").to(
                           torch.float32)], -1)
    thresh = torch.clamp(rel_conf * vals[0], min=min_conf)
    return kps, vals > thresh, vals


def _gather_patches(img: torch.Tensor, kps: torch.Tensor, size: int):
    """(K, size*size) zero-mean, unit-norm patches around the keypoints'
    integer pixels (clamped at the border)."""
    half = size // 2
    H, W = img.shape
    off = torch.arange(-half, size - half, device=img.device)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    y = (kps[:, 1:2].to(torch.int64) + oy.reshape(1, -1)).clamp(0, H - 1)
    x = (kps[:, 0:1].to(torch.int64) + ox.reshape(1, -1)).clamp(0, W - 1)
    p = img[y, x]
    p = p - p.mean(dim=1, keepdim=True)
    n = torch.linalg.norm(p, dim=1, keepdim=True)
    return p / torch.clamp(n, min=1e-8)


def intensity_centroid_angles(img: torch.Tensor, kps: torch.Tensor,
                              radius: int = 7) -> torch.Tensor:
    """ORB intensity-centroid orientation atan2(m01, m10) over a circular
    patch (radians; image y grows downward)."""
    H, W = img.shape
    off = torch.arange(-radius, radius + 1, device=img.device)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    circ = (ox * ox + oy * oy <= radius * radius).to(torch.float32)
    oy, ox = oy.reshape(1, -1), ox.reshape(1, -1)
    y = (kps[:, 1:2].to(torch.int64) + oy).clamp(0, H - 1)
    x = (kps[:, 0:1].to(torch.int64) + ox).clamp(0, W - 1)
    p = img[y, x] * circ.reshape(1, -1)
    m10 = (p * ox).sum(dim=1)
    m01 = (p * oy).sum(dim=1)
    return torch.atan2(m01, m10)


def _edge_index(n: int, pad: int, dev) -> torch.Tensor:
    return torch.arange(-pad, n + pad, device=dev).clamp(0, n - 1)


def _sep_conv(x: torch.Tensor, k) -> torch.Tensor:
    """Separable 2-D convolution (SAME, edge padding) with a 1-D kernel,
    summed tap by tap in the reference's order."""
    pad = len(k) // 2
    H, W = x.shape
    xp = x[_edge_index(H, pad, x.device)]
    acc = 0
    for i in range(len(k)):
        acc = acc + xp[i:i + H] * k[i]
    xp = acc[:, _edge_index(W, pad, x.device)]
    acc = 0
    for i in range(len(k)):
        acc = acc + xp[:, i:i + W] * k[i]
    return acc


def _kernel(values, dev) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=dev)


def harris_score(gray: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Raw Harris corner response map."""
    g = gray.to(torch.float32)
    gb = _sep_conv(g, _kernel([0.25, 0.5, 0.25], g.device))
    dy = torch.gradient(gb, dim=0)[0]
    dx = torch.gradient(gb, dim=1)[0]
    blur = _kernel([1., 4., 6., 4., 1.], g.device) / 16.0
    ixx = _sep_conv(dx * dx, blur)
    iyy = _sep_conv(dy * dy, blur)
    ixy = _sep_conv(dx * dy, blur)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def _subpixel_refine(score: torch.Tensor, kps: torch.Tensor) -> torch.Tensor:
    """Quadratic sub-pixel peak refinement on the raw score map."""
    H, W = score.shape
    x = kps[:, 0].to(torch.int64)
    y = kps[:, 1].to(torch.int64)
    xm, xp = (x - 1).clamp(0, W - 1), (x + 1).clamp(0, W - 1)
    ym, yp = (y - 1).clamp(0, H - 1), (y + 1).clamp(0, H - 1)

    def off(sm, s0, sp):
        denom = sm - 2 * s0 + sp
        denom = torch.where(denom.abs() < 1e-20,
                            torch.full_like(denom, 1e-20), denom)
        return (0.5 * (sm - sp) / denom).clamp(-0.5, 0.5)

    dx = off(score[y, xm], score[y, x], score[y, xp])
    dy = off(score[ym, x], score[y, x], score[yp, x])
    return kps + torch.stack([dx, dy], -1)


class HarrisExtractor:
    """Harris corners + 11x11 normalized patch descriptors."""

    def __init__(self, max_kps: int = 1000, nms_radius: int = 3,
                 border: int = 6, k: float = 0.04, min_conf: float = 0.0,
                 rel_conf: float = 1e-6, patch: int = 11):
        self.max_kps = max_kps
        self.nms_radius, self.border, self.k = nms_radius, border, k
        self.min_conf, self.rel_conf, self.patch = min_conf, rel_conf, patch

    def extract(self, gray: torch.Tensor):
        g = gray.to(torch.float32)
        gb = _sep_conv(g, _kernel([0.25, 0.5, 0.25], g.device))
        score = harris_score(g, self.k)
        nms = torch.where(_maxpool_nms(score, self.nms_radius), score,
                          torch.full_like(score, -float("inf")))
        kps, valid, _ = _topk_keypoints(nms, self.max_kps, self.border,
                                        self.min_conf, self.rel_conf)
        kps = _subpixel_refine(score, kps)
        desc = _gather_patches(gb, kps, self.patch)
        angles = intensity_centroid_angles(gb, kps)
        return kps, desc, valid, angles


class SuperPointExtractor:
    """Not ported: raises (ROADMAP Queue 1 item 11)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(SUPERPOINT_TODO)
