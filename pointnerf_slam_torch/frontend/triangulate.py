"""Two-view DLT triangulation and map-point acceptance checks (the JAX
reference's frontend/triangulate.py): positive depth in both views, small
reprojection error, sufficient parallax. CV camera convention (z forward,
normalized coords x / z)."""

from __future__ import annotations

import torch


def null_vectors(A: torch.Tensor):
    """Right singular vector of the smallest singular value of each (..., m,
    n) matrix, and a mask of the matrices that were finite (non-finite ones
    are solved as zeros; the caller drops them)."""
    finite = torch.isfinite(A).all(dim=-1).all(dim=-1)
    _, _, vh = torch.linalg.svd(torch.nan_to_num(A, 0.0, 0.0, 0.0))
    return vh[..., -1, :], finite


def triangulate_points(Tcw_cur: torch.Tensor, Tcw_ref: torch.Tensor,
                       kpn_cur: torch.Tensor, kpn_ref: torch.Tensor):
    """DLT in world coordinates from (4, 4) world->camera transforms and
    (N, 2) normalized coords. Returns pts3d (N, 3), ok (N,)."""
    P_cur, P_ref = Tcw_cur[:3], Tcw_ref[:3]
    A = torch.stack([
        kpn_cur[:, 0:1] * P_cur[2] - P_cur[0],
        kpn_cur[:, 1:2] * P_cur[2] - P_cur[1],
        kpn_ref[:, 0:1] * P_ref[2] - P_ref[0],
        kpn_ref[:, 1:2] * P_ref[2] - P_ref[1]], dim=1)        # (N, 4, 4)
    X, finite = null_vectors(A)
    w = X[:, 3]
    good = w.abs() > 1e-12
    pts = X[:, :3] / torch.where(good, w, torch.ones_like(w))[:, None]
    return pts, good & finite & torch.isfinite(pts).all(dim=1)


def point_checks(pts3d: torch.Tensor, Tcw_cur: torch.Tensor,
                 Tcw_ref: torch.Tensor, kpn_cur: torch.Tensor,
                 kpn_ref: torch.Tensor, fx: float,
                 max_reproj_px: float = 3.0,
                 cos_max_parallax: float = 0.9998):
    """Acceptance per Map.add_points. Returns (accept, z_cur, z_ref,
    uvn_cur, uvn_ref): camera depths and normalized reprojections."""
    xc = pts3d @ Tcw_cur[:3, :3].T + Tcw_cur[:3, 3]
    xr = pts3d @ Tcw_ref[:3, :3].T + Tcw_ref[:3, 3]
    z_cur, z_ref = xc[:, 2], xr[:, 2]

    def safe(z):
        return torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)

    uvn_cur = xc[:, :2] / safe(z_cur)[:, None]
    uvn_ref = xr[:, :2] / safe(z_ref)[:, None]
    err_cur = torch.linalg.norm(uvn_cur - kpn_cur, dim=1) * fx
    err_ref = torch.linalg.norm(uvn_ref - kpn_ref, dim=1) * fx
    c_cur = -Tcw_cur[:3, :3].T @ Tcw_cur[:3, 3]
    c_ref = -Tcw_ref[:3, :3].T @ Tcw_ref[:3, 3]
    r1, r2 = pts3d - c_cur, pts3d - c_ref
    cosp = (r1 * r2).sum(-1) / torch.clamp(
        torch.linalg.norm(r1, dim=1) * torch.linalg.norm(r2, dim=1),
        min=1e-12)
    accept = ((z_cur > 0) & (z_ref > 0) & (err_cur < max_reproj_px)
              & (err_ref < max_reproj_px) & (cosp < cos_max_parallax))
    return accept, z_cur, z_ref, uvn_cur, uvn_ref
