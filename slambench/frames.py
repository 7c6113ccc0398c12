"""The procedural furnished room (v3) as a frame source, ray-cast on the
device.

A torch copy of the port's synthetic reader (`io/synthetic.py`): the same
room and furniture boxes, the same sharp-plus-smooth 3-D texture, the same
breathing look-at orbit. The reader casts each 680x1200 frame in host
numpy (1-2 s a frame); here the whole sequence the run needs is cast on
the device in float64 during set-up, then handed over as the reader hands
it: host numpy float32 colour (H, W, 3) and depth (H, W), and the float32
c2w pose. The frames do not depend on the seed, as a dataset does not.

Camera convention: c2w with camera -z forward and +y up; depth is the
z-buffer depth along the camera's forward axis.
"""

from __future__ import annotations

import numpy as np
import torch

ROOM_HALF = 2.0
# furniture AABBs (lo, hi), in the reader's order
BOXES = (
    ((-0.6, -2.0, -0.7), (0.4, -0.8, 0.3)),
    ((-0.4, 0.15, -2.0), (0.3, 0.75, -0.7)),
    ((1.55, -0.5, -2.0), (2.0, 0.6, 0.9)),
    ((-1.1, 1.6, -2.0), (-0.2, 2.0, 1.2)),
    ((-2.0, -0.9, -2.0), (-1.5, -0.1, -0.9)),
    ((1.4, 1.4, -2.0), (1.8, 1.8, 2.0)),
    ((0.55, 0.35, -2.0), (0.95, 0.75, -1.55)),
)


def lookat_c2w(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """c2w (4, 4) float64 with camera -z toward target, +y about up."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    z = -fwd
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


def trajectory(n_frames: int, orbit: float, scale: float = 1.0) -> list:
    """The breathing orbit: n_frames float32 c2w poses over `orbit` turns."""
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * i / max(n_frames, 1) * orbit
        r = 1.2 + 0.18 * np.sin(3 * a)
        eye = (r * np.cos(a), r * np.sin(a), 0.35 + 0.1 * np.sin(2 * a))
        target = (0.4 * np.cos(a + 2.3), 0.4 * np.sin(a + 2.3),
                  0.1 * np.sin(a + 0.7))
        c2w = lookat_c2w(eye, target)
        c2w[:3, 3] *= scale
        poses.append(c2w.astype(np.float32))
    return poses


def _ray_cast(o: torch.Tensor, d: torch.Tensor):
    """Nearest hit t, hit points and furniture mask of (N, 3) float64 rays:
    the room's exit, each box's entry."""
    d = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    slab = torch.tensor([-ROOM_HALF, ROOM_HALF], dtype=d.dtype,
                        device=d.device)
    t = ((slab - o[..., None]) / d[..., None]).amax(-1).amin(-1)
    box = torch.zeros(t.shape, dtype=torch.bool, device=d.device)
    for lo, hi in BOXES:
        t1 = (torch.tensor(lo, dtype=d.dtype, device=d.device) - o) / d
        t2 = (torch.tensor(hi, dtype=d.dtype, device=d.device) - o) / d
        t_near = torch.minimum(t1, t2).amax(-1)
        t_far = torch.maximum(t1, t2).amin(-1)
        hit = (t_near <= t_far) & (t_near > 1e-6) & (t_near < t)
        t = torch.where(hit, t_near, t)
        box |= hit
    return t, o + d * t[..., None], box


def _color(p: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """The reader's texture in [0, 1] (float64 in, float32 out)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    base = 0.5 + 0.5 * torch.stack([
        torch.sin(1.7 * x + 0.9 * y),
        torch.sin(1.3 * y + 1.1 * z + 2.0),
        torch.sin(2.1 * z + 0.7 * x + 4.0)], dim=-1)
    detail = (torch.sin(7.3 * x + 0.5) * torch.sin(8.1 * y + 1.2)
              * torch.sin(6.7 * z + 2.1))
    base = (base * (0.85 + 0.25 * detail[..., None])).clamp(0.0, 1.0)

    def cells(freq, seed):
        c = torch.floor(p * freq)
        h = torch.sin(c[..., 0] * 12.9898 + c[..., 1] * 78.233
                      + c[..., 2] * 37.719 + seed) * 43758.5453
        return h - torch.floor(h)

    sharp = 0.65 * cells(12.0, 0.0) + 0.35 * cells(4.7, 9.1)
    tex = (base * (0.70 + 0.45 * sharp[..., None])).clamp(0.0, 1.0)
    tint = torch.tensor([0.9, 0.4, 0.2], dtype=p.dtype, device=p.device)
    boxed = (0.3 * tex + 0.7 * tint * (0.75 + 0.4 * sharp[..., None])
             ).clamp(0.0, 1.0)
    return torch.where(box[..., None], boxed, tex).to(torch.float32)


def render(c2w_unscaled: np.ndarray, cam: dict, device) -> tuple:
    """Colour (H, W, 3) and depth (H, W), float32 tensors on `device`, of
    the room seen from c2w (4, 4) (translation in room units)."""
    H, W = cam["H"], cam["W"]
    f64 = dict(dtype=torch.float64, device=device)
    j, i = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64),
                          indexing="ij")
    dirs = torch.stack([(i - cam["cx"]) / cam["fx"],
                        -(j - cam["cy"]) / cam["fy"],
                        -torch.ones_like(i)], dim=-1)
    R = torch.as_tensor(np.asarray(c2w_unscaled[:3, :3], np.float64),
                        **f64)
    rays_d = (dirs @ R.T).reshape(-1, 3)
    rays_o = torch.as_tensor(np.asarray(c2w_unscaled[:3, 3], np.float64),
                             **f64).expand_as(rays_d)
    t, pts, box = _ray_cast(rays_o, rays_d)
    return (_color(pts, box).reshape(H, W, 3),
            t.to(torch.float32).reshape(H, W))


class FrameSource:
    """The reader interface the system and its front-end call:
    source[idx] -> (idx, colour, depth, c2w) as host numpy float32.

    `seq`: the traffic's sequence ({"n_frames", "orbit"}); `cam`: the
    configuration's camera; `n_render`: how many leading frames are cast
    (all on `device`, at construction). len() is the sequence's length;
    reading a frame past the cast ones raises, naming the shortfall."""

    def __init__(self, seq: dict, cam: dict, scale: float, n_render: int,
                 device):
        if cam.get("crop_edge", 0) or "crop_size" in cam:
            raise ValueError("the procedural room is cast uncropped")
        self.n_frames = int(seq["n_frames"])
        self.n_render = min(int(n_render), self.n_frames)
        self.poses = trajectory(self.n_frames, float(seq["orbit"]), scale)
        self.scale = scale
        H, W = cam["H"], cam["W"]
        self.color = np.empty((self.n_render, H, W, 3), np.float32)
        self.depth = np.empty((self.n_render, H, W), np.float32)
        for k in range(self.n_render):
            c2w = self.poses[k].copy()
            c2w[:3, 3] /= scale
            col, dep = render(c2w, cam, device)
            self.color[k] = col.cpu().numpy()
            self.depth[k] = (dep * scale).cpu().numpy()

    def __len__(self):
        return self.n_frames

    def __getitem__(self, idx: int):
        if idx >= self.n_render:
            raise RuntimeError(
                f"frame source exhausted: frame {idx} asked for, "
                f"{self.n_render} cast; the traffic's render_frames is too "
                f"short for this window")
        return idx, self.color[idx], self.depth[idx], self.poses[idx].copy()
