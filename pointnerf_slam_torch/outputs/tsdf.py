"""Projective TSDF integration and the convex-hull scene bound (the JAX
reference's outputs/tsdf.py: the capability of upstream
get_bound_from_frames, Open3D TSDF fusion over the keyframes, then the
convex hull of the fused surface scaled by clean_mesh_bound_scale, which
masks the mesher's grid).

The TSDF is a dense voxel grid on the keyframes' device: every voxel
projects into every keyframe, samples its depth bilinearly and adds a
truncated SDF and a weight. The hull is scipy's, on the host, over the
near-surface voxels (the same seeded subset of 4000 as the reference);
its containment test runs on the device of the points it is given.
"""

from __future__ import annotations

import numpy as np
import torch


def tsdf_integrate(depths: torch.Tensor, c2ws: torch.Tensor, fx, fy, cx, cy,
                   bound: torch.Tensor, nx: int, ny: int, nz: int,
                   trunc: float = 0.12):
    """Integrate K depth maps (K, H, W) seen from c2ws (K, 4, 4) (NeRF
    -y/-z convention) into a TSDF over `bound` (3, 2). Returns (tsdf,
    weight), each (nx, ny, nz)."""
    H, W = depths.shape[1:]
    dev = depths.device
    axes = [torch.linspace(float(bound[i, 0]), float(bound[i, 1]), n,
                           device=dev) for i, n in enumerate((nx, ny, nz))]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    tsdf_sum = torch.zeros(pts.shape[0], device=dev)
    w_sum = torch.zeros(pts.shape[0], device=dev)
    for depth, c2w in zip(depths, c2ws):
        w2c = torch.linalg.inv(c2w)
        pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
        z = -pc[:, 2]
        zsafe = z.clamp(min=1e-6)
        u = pc[:, 0] / zsafe * fx + cx
        v = -pc[:, 1] / zsafe * fy + cy
        inside = (z > 1e-6) & (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1)
        u0 = torch.floor(u).clamp(0, W - 2).long()
        v0 = torch.floor(v).clamp(0, H - 2).long()
        fu = u - u0
        fv = v - v0
        d = (depth[v0, u0] * (1 - fu) * (1 - fv)
             + depth[v0, u0 + 1] * fu * (1 - fv)
             + depth[v0 + 1, u0] * (1 - fu) * fv
             + depth[v0 + 1, u0 + 1] * fu * fv)
        sdf = d - z
        w = (inside & (d > 0) & (sdf > -trunc)).to(torch.float32)
        tsdf_sum += (sdf / trunc).clamp(-1.0, 1.0) * w
        w_sum += w
    tsdf = tsdf_sum / w_sum.clamp(min=1e-6)
    return tsdf.reshape(nx, ny, nz), w_sum.reshape(nx, ny, nz)


def scene_bound_hull(depths, c2ws, fx, fy, cx, cy, bound,
                     resolution: int = 64, scale: float = 1.02):
    """Convex hull of the fused surface, enlarged by `scale` about its
    centroid. Returns a containment test fn(points (N, 3) tensor) -> (N,)
    bool on the points' device, or None when too few surface voxels (or a
    degenerate set) make no hull."""
    from scipy.spatial import ConvexHull, QhullError

    bound = np.asarray(bound)
    tsdf, w = tsdf_integrate(
        depths, c2ws, fx, fy, cx, cy,
        torch.as_tensor(bound, dtype=torch.float32), resolution, resolution,
        resolution)
    tsdf, w = tsdf.cpu().numpy(), w.cpu().numpy()
    idx = np.argwhere((np.abs(tsdf) < 0.5) & (w > 0))
    if len(idx) < 8:
        return None
    step = (bound[:, 1] - bound[:, 0]) / (resolution - 1)
    pts = bound[:, 0] + idx * step
    centroid = pts.mean(0)
    pts = centroid + (pts - centroid) * scale
    sub = pts[np.random.default_rng(0).permutation(len(pts))[:4000]]
    try:
        eq = ConvexHull(sub).equations           # n . x + c <= 0 inside
    except QhullError:
        return None

    def contains(q: torch.Tensor) -> torch.Tensor:
        e = torch.as_tensor(eq, dtype=torch.float64, device=q.device)
        q = q.to(torch.float64)
        ok = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
        for f in e:                 # facet by facet: no (N, F) temporary
            ok &= q @ f[:3] + f[3] <= 1e-12
        return ok

    return contains
