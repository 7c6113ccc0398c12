"""Reconstruction metrics of a mesh against the ground truth (the JAX
reference's tools/eval_recon.py; numpy and scipy on the host, with the
reference's random streams, so both packages' tools give the same numbers
on the same meshes).

3D: 200,000 area-weighted surface samples of each mesh, the
reconstruction aligned to the ground truth by point-to-point ICP (scipy's
cKDTree), then accuracy and completion (mean nearest distance, cm) and the
completion ratio (% of ground-truth samples within 5 cm).

2D: depth-L1 (cm) between the two meshes' depth maps, cast by the native
BVH ray caster (tools/raycast.py) from random in-room views (origins in
the ground truth's shrunken oriented bounding box, targets uniform in
[-10000, 10000]^3, up (0, 0, -1)). A view is drawn again while any point
of the unseen ground-truth point cloud ({gt%.ply}_pc_unseen.npy, written
by cull_mesh --save_unseen_pc) projects into it; without that cloud,
while more than 10% of the ground truth's pixels are empty.
--no_reject_unseen turns the rejection off.

  python -m pointnerf_slam_torch.tools.eval_recon --rec_mesh <ply>
      --gt_mesh <ply> [-3d] [-2d] [--n_imgs N] [--no_reject_unseen]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from scipy.spatial import cKDTree

from ..outputs.mesher import read_ply


def sample_mesh_surface(verts: np.ndarray, tris: np.ndarray, n: int,
                        rng=None):
    """n points uniform on the surface (faces drawn by area)."""
    rng = rng or np.random.default_rng(0)
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    idx = rng.choice(len(tris), n, p=areas / areas.sum())
    u = rng.uniform(size=(n, 1))
    v = rng.uniform(size=(n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return a[idx] + u * (b[idx] - a[idx]) + v * (c[idx] - a[idx])


def icp_align(src: np.ndarray, dst: np.ndarray, iters: int = 30,
              subsample: int = 20000, rng=None):
    """Point-to-point ICP: the (4, 4) transform aligning src to dst."""
    rng = rng or np.random.default_rng(1)
    T = np.eye(4)
    cur = src
    tree = cKDTree(dst)
    for _ in range(iters):
        sel = rng.choice(len(cur), min(subsample, len(cur)), replace=False)
        s = cur[sel]
        _, nn = tree.query(s, workers=-1)
        d = dst[nn]
        sm, dm = s.mean(0), d.mean(0)
        U, _, Vt = np.linalg.svd((s - sm).T @ (d - dm))
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        R = Vt.T @ S @ U.T
        dT = np.eye(4)
        dT[:3, :3] = R
        dT[:3, 3] = dm - R @ sm
        T = dT @ T
        cur = src @ T[:3, :3].T + T[:3, 3]
    return T


def completion_ratio(gt: np.ndarray, rec: np.ndarray,
                     dist_th: float = 0.05) -> float:
    d, _ = cKDTree(rec).query(gt, workers=-1)
    return float((d < dist_th).mean())


def accuracy(gt: np.ndarray, rec: np.ndarray) -> float:
    d, _ = cKDTree(gt).query(rec, workers=-1)
    return float(d.mean())


def completion(gt: np.ndarray, rec: np.ndarray) -> float:
    d, _ = cKDTree(rec).query(gt, workers=-1)
    return float(d.mean())


def calc_3d_metric(rec_ply: str, gt_ply: str, n_samples: int = 200000,
                   align: bool = True) -> dict:
    """Accuracy and completion (cm), completion ratio (%)."""
    rv, rt, _ = read_ply(rec_ply)
    gv, gt_t, _ = read_ply(gt_ply)
    rec = sample_mesh_surface(rv, rt, n_samples)
    gt = sample_mesh_surface(gv, gt_t, n_samples)
    if align:
        T = icp_align(rec, gt)
        rec = rec @ T[:3, :3].T + T[:3, 3]
    return {"accuracy": accuracy(gt, rec) * 100,
            "completion": completion(gt, rec) * 100,
            "completion ratio": completion_ratio(gt, rec) * 100}


def _normalize(x):
    return x / max(np.linalg.norm(x), 1e-12)


def _viewmatrix(z, up, pos):
    """Camera whose z axis points along z (CV convention): columns
    [x, y, z, pos]."""
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    m = np.eye(4)
    m[:3, :4] = np.stack([vec0, vec1, vec2, pos], 1)
    return m


def oriented_bounds(verts: np.ndarray):
    """PCA oriented bounding box: (extents (3,), to_origin (4, 4)) such
    that verts @ to_origin is centred and axis-aligned."""
    c = verts.mean(0)
    sub = verts[:: max(len(verts) // 50000, 1)] - c
    _, _, Vt = np.linalg.svd(sub, full_matrices=False)
    proj = (verts - c) @ Vt.T
    lo, hi = proj.min(0), proj.max(0)
    center = c + Vt.T @ ((lo + hi) / 2)
    to_origin = np.eye(4)
    to_origin[:3, :3] = Vt
    to_origin[:3, 3] = -Vt @ center
    return hi - lo, to_origin


def check_proj(points: np.ndarray, W, H, fx, fy, cx, cy, c2w) -> bool:
    """True if any point projects inside the view (the reference's
    OpenGL -> CV flips, the -x camera flip and its z < 0 front test)."""
    if len(points) == 0:
        return False
    c2w = c2w.copy()
    c2w[:3, 1] *= -1.0
    c2w[:3, 2] *= -1.0
    w2c = np.linalg.inv(c2w)
    pc = points @ w2c[:3, :3].T + w2c[:3, 3]
    z = pc[:, 2] + 1e-5
    u = (fx * (-pc[:, 0]) + cx * z) / z
    v = (fy * pc[:, 1] + cy * z) / z
    return bool(((z <= 0) & (u > 0) & (u < W) & (v > 0) & (v < H)).sum() > 0)


def calc_2d_metric(rec_ply: str, gt_ply: str, n_imgs: int = 1000,
                   H: int = 500, W: int = 500, fx: float = 300.0,
                   seed: int = 0, unseen_pc=None, align: bool = False,
                   reject_unseen: bool = True) -> dict:
    """Depth-L1 (cm) over n_imgs random in-room views, and the count of
    views."""
    from .raycast import MeshRaycaster

    rv, rt, _ = read_ply(rec_ply)
    gv, gt_t, _ = read_ply(gt_ply)
    if align:
        T = icp_align(sample_mesh_surface(rv, rt, 50000),
                      sample_mesh_surface(gv, gt_t, 50000))
        rv = rv @ T[:3, :3].T + T[:3, 3]
    rc_rec = MeshRaycaster(rv, rt)
    rc_gt = MeshRaycaster(gv, gt_t)

    if unseen_pc is None:
        auto = gt_ply.replace(".ply", "_pc_unseen.npy")
        unseen_pc = auto if os.path.exists(auto) else None
    if isinstance(unseen_pc, str):
        unseen_pc = np.load(unseen_pc)
    if not reject_unseen:
        unseen_pc = None

    fy = fx
    cx, cy = W / 2.0 - 0.5, H / 2.0 - 0.5
    extents, to_origin = oriented_bounds(gv)
    extents = extents * np.array([0.3, 0.7, 0.7])
    transform = np.linalg.inv(to_origin)
    transform[2, 3] += 0.4
    up = np.array([0.0, 0.0, -1.0])

    rng = np.random.default_rng(seed)
    errs = []
    tries = 0
    while len(errs) < n_imgs and tries < n_imgs * 20:
        tries += 1
        origin_box = rng.uniform(-extents / 2, extents / 2)
        origin = transform[:3, :3] @ origin_box + transform[:3, 3]
        target = rng.uniform(-10000, 10000, 3) - origin
        c2w = _viewmatrix(target, up, origin)
        if unseen_pc is not None \
                and check_proj(unseen_pc, W, H, fx, fy, cx, cy, c2w):
            continue
        d_gt = _render_depth_c2w(rc_gt, c2w, H, W, fx, cx, cy)
        if unseen_pc is None and (d_gt <= 0).mean() > 0.1:
            continue
        d_rec = _render_depth_c2w(rc_rec, c2w, H, W, fx, cx, cy)
        # unmasked mean |gt - ours|: missed rays render 0 in both
        errs.append(np.abs(d_gt - d_rec).mean())
    return {"depth l1": float(np.mean(errs)) * 100 if errs else float("nan"),
            "n_views": len(errs)}


def _render_depth_c2w(rc, c2w, H, W, fx, cx, cy, z_far: float = 20.0):
    """z-depth map under a CV-convention (+z forward) pose; misses and hits
    beyond z_far render 0."""
    X, Y, Z = c2w[:3, 0], c2w[:3, 1], c2w[:3, 2]
    eye = c2w[:3, 3]
    j, i = np.mgrid[0:H, 0:W]
    dirs = ((i - cx)[..., None] * X + (j - cy)[..., None] * Y
            + fx * Z).reshape(-1, 3)
    t = rc.cast(np.broadcast_to(eye, dirs.shape).astype(np.float32),
                dirs.astype(np.float32))
    z = t * fx          # dir . Z == fx, so the z-depth is t * fx
    z[~np.isfinite(z)] = 0
    z[t < 0] = 0
    z[z > z_far] = 0
    return z.reshape(H, W)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rec_mesh", required=True)
    p.add_argument("--gt_mesh", required=True)
    p.add_argument("-3d", "--metric_3d", action="store_true")
    p.add_argument("-2d", "--metric_2d", action="store_true")
    p.add_argument("--n_imgs", type=int, default=1000)
    p.add_argument("--unseen_pc", type=str, default=None,
                   help="unseen ground-truth point cloud (.npy); default "
                        "{gt_mesh%%.ply}_pc_unseen.npy if present")
    p.add_argument("--no_reject_unseen", action="store_true",
                   help="turn the unseen-region view rejection off")
    args = p.parse_args(argv)
    if args.metric_3d:
        print(calc_3d_metric(args.rec_mesh, args.gt_mesh))
    if args.metric_2d:
        print(calc_2d_metric(args.rec_mesh, args.gt_mesh,
                             n_imgs=args.n_imgs, unseen_pc=args.unseen_pc,
                             reject_unseen=not args.no_reject_unseen))


if __name__ == "__main__":
    main()
