"""Projection-guided matching (the JAX reference's frontend/search.py; the
upstream src/search_points.py utilities as dense masked argmins over
(P, K) distance matrices, on torch tensors):

  - search_frame_by_projection: project map points into a frame, match
    each to the keypoint of least descriptor distance within a pixel
    radius.
  - search_map_by_projection: the same behind viewing-angle and distance
    gates.
  - propagate_map_point_matches: carry the reference frame's point slots
    through keypoint matches.
  - search_frame_for_triangulation: epipolar-gated descriptor matching
    between two keyframes.
  - search_and_fuse: fuse map points (frontend.mapstore) into a
    keyframe's keypoint slots.

argmin takes the first index on ties, as jnp.argmin does.
"""

from __future__ import annotations

import numpy as np
import torch


def _desc_dist(d1, d2):
    sim = (d1 @ d2.T).clamp(-1.0, 1.0)
    return torch.sqrt(torch.clamp(2.0 - 2.0 * sim, min=0.0))


def _best(cost):
    idx = torch.argmin(cost, dim=1)
    return idx, torch.gather(cost, 1, idx[:, None])[:, 0]


def search_frame_by_projection(pts3d, pt_desc, pt_valid, Tcw, kps, kp_desc,
                               kp_valid, fx, fy, cx, cy,
                               radius_px: float = 10.0,
                               max_desc_dist: float = 0.7):
    """Match projected map points to frame keypoints.

    pts3d (P, 3) world points, pt_desc (P, D), pt_valid (P,); Tcw (4, 4)
    w2c (CV convention); kps (K, 2) pixels, kp_desc (K, D), kp_valid (K,).
    Returns kp_idx (P,) best keypoint per point and match_valid (P,)."""
    pc = pts3d @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    proj = torch.stack([pc[:, 0] / zs * fx + cx, pc[:, 1] / zs * fy + cy],
                       -1)
    d_px = torch.linalg.norm(proj[:, None, :] - kps[None], dim=-1)
    cost = torch.where((d_px < radius_px) & kp_valid[None, :],
                       _desc_dist(pt_desc, kp_desc),
                       torch.full_like(d_px, 1e6))
    kp_idx, best = _best(cost)
    return kp_idx, pt_valid & (z > 0) & (best < max_desc_dist)


def search_map_by_projection(pts3d, pt_desc, pt_valid, pt_normal,
                             pt_max_dist, Tcw, kps, kp_desc, kp_valid,
                             fx, fy, cx, cy, radius_px: float = 10.0,
                             max_desc_dist: float = 0.7,
                             view_cos_min: float = 0.5):
    """search_frame_by_projection behind viewing-angle and distance
    gates."""
    C = -Tcw[:3, :3].T @ Tcw[:3, 3]
    view = pts3d - C
    dist = torch.linalg.norm(view, dim=-1)
    view_dir = view / torch.clamp(dist[:, None], min=1e-9)
    cos_view = (view_dir * pt_normal).sum(-1)
    gate = pt_valid & (cos_view > view_cos_min) & (dist < pt_max_dist)
    kp_idx, ok = search_frame_by_projection(
        pts3d, pt_desc, gate, Tcw, kps, kp_desc, kp_valid, fx, fy, cx, cy,
        radius_px, max_desc_dist)
    return kp_idx, ok & gate


def propagate_map_point_matches(ref_has_point, idx_ref, idx_cur,
                                match_valid):
    """For each match (ref keypoint i -> current keypoint j) the current
    keypoint inherits the ref keypoint's map-point slot where it has one.
    Returns (point_src (K,): the ref keypoint whose point propagates, -1
    where none; valid (K,))."""
    ok = match_valid & ref_has_point[idx_ref]
    return torch.where(ok, idx_ref, torch.full_like(idx_ref, -1)), ok


def search_frame_for_triangulation(kpn1, desc1, valid1, kpn2, desc2, valid2,
                                   E, max_desc_dist: float = 0.7,
                                   epi_thresh: float = 3e-3):
    """Epipolar-gated matching between two keyframes: a pair is a
    candidate where |x2^T E x1| / ||line|| < epi_thresh; the best
    descriptor distance among the candidates wins."""
    x1 = torch.cat([kpn1, torch.ones_like(kpn1[:, :1])], -1)   # (K1, 3)
    x2 = torch.cat([kpn2, torch.ones_like(kpn2[:, :1])], -1)   # (K2, 3)
    lines = x1 @ E.T                                           # (K1, 3)
    num = (x2 @ lines.T).abs()                                 # (K2, K1)
    den = torch.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2)[None]
    epi = num / torch.clamp(den, min=1e-12)
    ok = (epi.T < epi_thresh) & valid1[:, None] & valid2[None]
    dd = _desc_dist(desc1, desc2)
    idx2, best = _best(torch.where(ok, dd, torch.full_like(dd, 1e6)))
    return idx2, best < max_desc_dist


def search_and_fuse(map_obj, kf, fx, fy, cx, cy, radius_px: float = 6.0,
                    max_desc_dist: float = 0.5):
    """Fuse map points with a keyframe's keypoints: a matched point fills
    an empty keypoint slot, or merges with the slot's point (the better
    observed one stays). Returns the number fused."""
    pts = [p for p in map_obj.points if not p.is_bad]
    if not pts:
        return 0
    P = np.stack([p.pt for p in pts])
    D = np.stack([p.des if p.des is not None
                  else np.zeros(kf.desc.shape[1]) for p in pts])

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    kp_idx, ok = search_frame_by_projection(
        f32(P), f32(D), torch.ones(len(pts), dtype=torch.bool), f32(kf.Tcw),
        f32(kf.kps), f32(kf.desc), torch.as_tensor(np.asarray(kf.valid)),
        fx, fy, cx, cy, radius_px, max_desc_dist)
    kp_idx = kp_idx.numpy()
    fused = 0
    for i in np.flatnonzero(ok.numpy()):
        mp = pts[i]
        slot = int(kp_idx[i])
        existing = kf.points[slot]
        if existing is None:
            mp.add_observation(kf, slot, kf.desc[slot])
            fused += 1
        elif existing is not mp and not existing.is_bad:
            if existing.num_observations >= mp.num_observations:
                mp.replace_with(existing)
            else:
                existing.replace_with(mp)
            fused += 1
    return fused
