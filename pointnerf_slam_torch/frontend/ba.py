"""Bundle adjustment (the JAX reference's frontend/ba.py; g2o's
capabilities as batched dense Gauss-Newton):

  - pose_optimization: motion-only refinement of one w2c camera tensor
    [qw qx qy qz tx ty tz] (CV convention) against fixed map points, Huber
    IRLS weights, 4 rounds of 10 iterations with chi2 (5.991) inlier
    reclassification after each round.
  - bundle_adjustment: windowed joint refinement of cameras and points by
    alternating batched Gauss-Newton steps (every camera's 7x7 solve, then
    every point's 3x3 solve over all cameras), L2 weights for the first
    l2_iters iterations and Huber after, fixed cameras held.

Jacobians come from forward-mode autodiff (torch.func.jacfwd, vmapped over
cameras or points) through the quaternion-to-rotation map the tracker
uses."""

from __future__ import annotations

import torch

from ..core.se3 import camera_from_tensor
from ..utils import tracing

CHI2_MONO = 5.991


def _residuals(cam7, pts, kpn):
    T = camera_from_tensor(cam7)
    pc = pts @ T[:3, :3].T + T[:3, 3]
    z = pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return pc[:, :2] / zs[:, None] - kpn, z


def _huber_w(r2, delta2):
    return torch.where(r2 <= delta2, torch.ones_like(r2),
                       torch.sqrt(delta2 / r2))


def _renorm(cam7):
    """Fix the quaternion scale gauge (quat_to_rot is scale-invariant)."""
    q = cam7[:4] / torch.linalg.norm(cam7[:4])
    return torch.cat([q, cam7[4:]])


def pose_optimization(cam7_init, pts, kpn, valid, sigma2: float = 1.0,
                      rounds: int = 4, iters_per_round: int = 10):
    """Refine cam7_init (7,) against world points pts (N, 3) observed at
    normalized kpn (N, 2) where valid (N,). sigma2: observation variance.
    Returns (cam7, inlier_mask, n_inliers)."""
    chi2_th = CHI2_MONO * sigma2
    eye7 = torch.eye(7, dtype=cam7_init.dtype, device=cam7_init.device)
    cam, inliers = cam7_init, valid
    for _ in range(rounds):
        r, z = _residuals(cam, pts, kpn)
        r2 = (r * r).sum(-1) / sigma2
        w = torch.sqrt(_huber_w(r2, chi2_th)) * valid.to(r.dtype) * (z > 0)

        def flat_res(c, w=w):
            return (_residuals(c, pts, kpn)[0] * w[:, None]).reshape(-1)

        for _ in range(iters_per_round):
            with tracing.span("frontend.pose_opt"):
                J = torch.func.jacfwd(flat_res)(cam)          # (2N, 7)
                res = flat_res(cam)
                H = J.T @ J + 1e-6 * eye7
                g = J.T @ res
            with tracing.wait("pose_optimization"):
                step = torch.linalg.solve(H, g)
            with tracing.span("frontend.pose_opt"):
                cam = _renorm(cam - step)
        r, z = _residuals(cam, pts, kpn)
        r2 = (r * r).sum(-1) / sigma2
        inliers = valid & (r2 < chi2_th) & (z > 0)
    return cam, inliers, inliers.sum()


def _project(cam7, pts):
    """Normalized coordinates (N, 2) and depth (N,) of world points in a
    w2c camera tensor."""
    T = camera_from_tensor(cam7)
    pc = pts @ T[:3, :3].T + T[:3, 3]
    z = pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return pc[:, :2] / zs[:, None], z


def _renorm_batch(cams7):
    q = cams7[:, :4] / torch.linalg.norm(cams7[:, :4], dim=-1, keepdim=True)
    return torch.cat([q, cams7[:, 4:]], -1)


def bundle_adjustment(cams7, pts, obs_kpn, obs_valid, fixed_cams,
                      sigma2: float = 1.0, iters: int = 10,
                      l2_iters: int = 5):
    """Windowed BA. cams7 (K, 7) w2c camera tensors, pts (M, 3) world
    points, obs_kpn (K, M, 2) normalized observations of point m in camera
    k where obs_valid (K, M), fixed_cams (K,) cameras held (the oldest
    keyframe, gt-anchored frames). Returns (cams7, pts, mean chi2 of the
    inlier observations)."""
    from torch.func import jacfwd, vmap
    huber2 = CHI2_MONO * sigma2
    dt, dev = pts.dtype, pts.device
    eye7 = torch.eye(7, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    valid_f = obs_valid.to(dt)

    def all_res(cams, pts):
        uv, z = vmap(_project, in_dims=(0, None))(cams, pts)
        return uv - obs_kpn, z

    def weights(cams, pts, robust):
        r, z = all_res(cams, pts)
        r2 = (r * r).sum(-1) / sigma2
        hw = _huber_w(r2, huber2) if robust else torch.ones_like(r2)
        return hw * valid_f * (z > 0)

    def cam_res(cam, w_k, kpn_k, pts):
        return ((_project(cam, pts)[0] - kpn_k) * w_k[:, None]).reshape(-1)

    def pt_res(p, w_m, kpn_m, cams):
        T = camera_from_tensor(cams)                       # (K, 3, 4)
        pc = T[:, :3, :3] @ p + T[:, :3, 3]
        zs = torch.where(pc[:, 2].abs() < 1e-9,
                         torch.full_like(pc[:, 2], 1e-9), pc[:, 2])
        uv = pc[:, :2] / zs[:, None]
        return ((uv - kpn_m) * w_m[:, None]).reshape(-1)

    def gn(res_fn, x, eye, *args):
        J = vmap(jacfwd(res_fn), in_dims=(0, 0, 0, None))(x, *args)
        r = vmap(res_fn, in_dims=(0, 0, 0, None))(x, *args)
        H = J.transpose(1, 2) @ J + 1e-5 * eye
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        return x - torch.linalg.solve(H, g)

    cams = cams7
    for it in range(iters):
        w = weights(cams, pts, it >= l2_iters)
        new = _renorm_batch(gn(cam_res, cams, eye7, w, obs_kpn, pts))
        cams = torch.where(fixed_cams[:, None], cams, new)
        pts = gn(pt_res, pts, eye3, w.T, obs_kpn.transpose(0, 1), cams)
    r, z = all_res(cams, pts)
    r2 = (r * r).sum(-1) / sigma2
    inl = obs_valid & (z > 0) & (r2 < huber2)
    mean_chi2 = (r2 * inl).sum() / torch.clamp(inl.sum(), min=1)
    return cams, pts, mean_chi2
