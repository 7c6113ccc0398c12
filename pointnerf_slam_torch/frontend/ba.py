"""Motion-only pose refinement (the JAX reference's frontend/ba.py
`pose_optimization`; capability of g2o's pose_optimization): Gauss-Newton
on one w2c camera tensor [qw qx qy qz tx ty tz] (CV convention) against
fixed map points, Huber IRLS weights, 4 rounds of 10 iterations with chi2
(5.991) inlier reclassification after each round. The Jacobian comes from
forward-mode autodiff through the same quaternion-to-rotation map the
tracker uses. The windowed `bundle_adjustment` of the reference is not on
the front-end's path and is not ported."""

from __future__ import annotations

import torch

from ..core.se3 import camera_from_tensor

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
            J = torch.func.jacfwd(flat_res)(cam)              # (2N, 7)
            res = flat_res(cam)
            H = J.T @ J + 1e-6 * eye7
            cam = _renorm(cam - torch.linalg.solve(H, J.T @ res))
        r, z = _residuals(cam, pts, kpn)
        r2 = (r * r).sum(-1) / sigma2
        inliers = valid & (r2 < chi2_th) & (z > 0)
    return cam, inliers, inliers.sum()
