"""Keypoint detection and description on the device (the JAX reference's
frontend/features.py), behind `extract(gray) -> (kps, desc, valid, angles)`:

  - `HarrisExtractor`: Harris corners with max-pool non-maximum
    suppression, a static top-K with validity, quadratic sub-pixel
    refinement, 11x11 normalized-patch descriptors and ORB-style
    intensity-centroid orientations.
  - `SuperPointExtractor`: the SuperPoint CNN (shared VGG encoder,
    65-channel detector head, 256-d descriptor head; the public MagicLeap
    SuperPointNet layout) as `SuperPointNet`, weights from the public
    `superpoint_v1.pth` state dict (`load_superpoint_torch`) or the
    packages' shared npz (`load_superpoint_npz`: `name.w` / `name.b`, the
    distilled `pretrained/superpoint_synthetic.npz`); max-pool NMS on the
    heatmap (losers score 0), the static top-K at conf_thresh, the same
    sub-pixel refinement, descriptors bilinearly sampled from the coarse
    map (the reference's own formula, align-corners mapping), and the
    intensity-centroid angles of the gray image.

The top-K is a stable descending sort, so equal scores keep the lower flat
index first (jax.lax.top_k's order; torch.topk promises none). The
convolutions run in float32: on the card TF32 is switched off around the
forward (cuDNN allows it by default; the reference computes in float32).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as Fn

from ..utils import tracing
from ..utils.device import resolve_device


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
    with tracing.wait("harris_kernel"):
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


# ---------------------------------------------------------------------------
# SuperPoint
# ---------------------------------------------------------------------------

_SP_LAYERS = [  # (name, in, out, kernel)
    ("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
    ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
    ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
    ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
]
_SP_HEADS = [("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
             ("convDa", 128, 256, 3), ("convDb", 256, 256, 1)]


def init_superpoint(generator: Optional[torch.Generator] = None) -> dict:
    """Random SuperPoint parameters (He init, zero biases) as {name: {"w":
    (out, in, k, k), "b": (out,)}}, the layout the loaders fill."""
    params = {}
    for name, cin, cout, ks in _SP_LAYERS + _SP_HEADS:
        w = torch.randn((cout, cin, ks, ks), generator=generator) \
            * float(np.sqrt(2.0 / (cin * ks * ks)))
        params[name] = {"w": w, "b": torch.zeros(cout)}
    return params


def load_superpoint_torch(path: str) -> dict:
    """Parameters from the public superpoint_v1.pth (a SuperPointNet state
    dict: `{name}.weight`, `{name}.bias`)."""
    sd = torch.load(path, map_location="cpu")
    return {name: {"w": sd[f"{name}.weight"].float(),
                   "b": sd[f"{name}.bias"].float()}
            for name, *_ in _SP_LAYERS + _SP_HEADS}


def save_superpoint_npz(path: str, params: dict) -> None:
    """Parameters as a flat npz of `name.w` / `name.b` arrays (the format
    both packages read)."""
    flat = {}
    for name, p in params.items():
        for kind in ("w", "b"):
            v = p[kind]
            flat[f"{name}.{kind}"] = v.detach().cpu().numpy() \
                if torch.is_tensor(v) else np.asarray(v)
    np.savez_compressed(path, **flat)


def load_superpoint_npz(path: str) -> dict:
    z = np.load(path)
    params = {}
    for k in z.files:
        name, kind = k.rsplit(".", 1)
        params.setdefault(name, {})[kind] = torch.from_numpy(
            np.asarray(z[k], np.float32))
    return params


class SuperPointNet(torch.nn.Module):
    """The SuperPoint network: 3x3 convolutions with padding 1 and 1x1 with
    padding 0, 2x2 max-pools of stride 2 after blocks 1-3; forward(x (B, 1,
    H, W)) -> (semi (B, 65, H/8, W/8) logits, unit-norm desc (B, 256, H/8,
    W/8))."""

    def __init__(self, params: Optional[dict] = None):
        super().__init__()
        for name, cin, cout, ks in _SP_LAYERS + _SP_HEADS:
            setattr(self, name, torch.nn.Conv2d(cin, cout, ks, 1, ks // 2))
        if params is not None:
            self.load_params(params)

    @torch.no_grad()
    def load_params(self, params: dict) -> None:
        for name, p in params.items():
            conv = getattr(self, name)
            conv.weight.copy_(torch.as_tensor(p["w"]))
            conv.bias.copy_(torch.as_tensor(p["b"]))

    def params(self) -> dict:
        return {name: {"w": getattr(self, name).weight,
                       "b": getattr(self, name).bias}
                for name, *_ in _SP_LAYERS + _SP_HEADS}

    def forward(self, x):
        relu = torch.relu
        for i, blk in enumerate(("conv1", "conv2", "conv3", "conv4")):
            x = relu(getattr(self, blk + "a")(x))
            x = relu(getattr(self, blk + "b")(x))
            if i < 3:
                x = Fn.max_pool2d(x, 2, 2)
        semi = self.convPb(relu(self.convPa(x)))
        desc = self.convDb(relu(self.convDa(x)))
        desc = desc / torch.clamp(torch.linalg.norm(desc, dim=1,
                                                    keepdim=True), min=1e-10)
        return semi, desc


def superpoint_forward(net: SuperPointNet, gray: torch.Tensor):
    """gray (H, W) in [0, 1], H and W multiples of 8 -> (heatmap (H, W),
    desc_coarse (256, H/8, W/8)): the softmax over the 65 channels without
    the dustbin, each cell's 64 channels laid out as its 8x8 pixels
    (row-major: pixel_shuffle)."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        semi, desc = net(gray.to(torch.float32)[None, None])
    dense = torch.softmax(semi, dim=1)[:, :-1]
    return Fn.pixel_shuffle(dense, 8)[0, 0], desc[0]


def _sample_desc(desc_coarse: torch.Tensor, kps: torch.Tensor, H: int,
                 W: int) -> torch.Tensor:
    """Bilinear samples of the coarse descriptor map at pixel keypoints
    (align-corners mapping of [0, W-1] onto [0, Wc-1]), renormalised."""
    D, Hc, Wc = desc_coarse.shape
    sx = (kps[:, 0] / (W - 1)) * (Wc - 1)
    sy = (kps[:, 1] / (H - 1)) * (Hc - 1)
    x0 = torch.floor(sx).to(torch.int64).clamp(0, Wc - 1)
    y0 = torch.floor(sy).to(torch.int64).clamp(0, Hc - 1)
    x1 = (x0 + 1).clamp(max=Wc - 1)
    y1 = (y0 + 1).clamp(max=Hc - 1)
    fx = (sx - x0)[:, None]
    fy = (sy - y0)[:, None]
    d = desc_coarse.permute(1, 2, 0)
    v = (d[y0, x0] * (1 - fx) * (1 - fy) + d[y0, x1] * fx * (1 - fy)
         + d[y1, x0] * (1 - fx) * fy + d[y1, x1] * fx * fy)
    return v / torch.clamp(torch.linalg.norm(v, dim=1, keepdim=True),
                           min=1e-10)


class SuperPointExtractor:
    """SuperPoint keypoints, descriptors and angles on `device` (the card
    unless the caller asks for the CPU). Weights: a .npz (the shared npz),
    another path (a superpoint_v1.pth state dict) or None (random, seeded
    0)."""

    def __init__(self, weights_path: Optional[str] = None,
                 max_kps: int = 3000, conf_thresh: float = 0.015,
                 nms_dist: int = 4, border: int = 4, device=None):
        if weights_path is not None and weights_path.endswith(".npz"):
            params = load_superpoint_npz(weights_path)
        elif weights_path is not None:
            params = load_superpoint_torch(weights_path)
        else:
            params = init_superpoint(torch.Generator().manual_seed(0))
        self.net = SuperPointNet(params).to(resolve_device(device)).eval()
        self.max_kps = max_kps
        self.conf_thresh, self.nms_dist, self.border = \
            conf_thresh, nms_dist, border

    @torch.no_grad()
    def extract(self, gray: torch.Tensor):
        H, W = gray.shape
        if H % 8 or W % 8:
            raise ValueError(f"SuperPoint needs H, W divisible by 8, got "
                             f"{H}x{W}")
        gray = gray.to(torch.float32)
        heat, desc_c = superpoint_forward(self.net, gray)
        score = torch.where(_maxpool_nms(heat, self.nms_dist), heat,
                            torch.zeros_like(heat))
        kps, valid, _ = _topk_keypoints(score, self.max_kps, self.border,
                                        self.conf_thresh)
        kps = _subpixel_refine(heat, kps)
        desc = _sample_desc(desc_c, kps, H, W)
        angles = intensity_centroid_angles(gray, kps)
        return kps, desc, valid, angles
