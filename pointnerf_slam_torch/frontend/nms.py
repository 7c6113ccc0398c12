"""Keypoint non-max-suppression zoo (the JAX reference's frontend/nms.py;
numpy, host side): the pluggable keypoint filters of the upstream
src/utils/utils_features.py
  - grid_nms  (:320-391): one best keypoint per grid cell
  - ssc_nms   (:231-306): adaptive suppression via square covering —
    binary-search the suppression radius so ~k keypoints survive
  - kdt_nms   (:178-229): radius suppression in response order (the greedy
    kd-tree walk becomes a numpy sweep at <= 3000 keypoints)

All take (kps (K,2), scores (K,), valid (K,)) and return a boolean keep
mask — composable with the static top-k extractor outputs.
"""

from __future__ import annotations

import numpy as np


def grid_nms(kps: np.ndarray, scores: np.ndarray, valid: np.ndarray,
             H: int, W: int, cell: int = 16) -> np.ndarray:
    """Best keypoint per cell of a (cell x cell) grid."""
    keep = np.zeros(len(kps), bool)
    cols = (W + cell - 1) // cell
    cid = (kps[:, 1].astype(int) // cell) * cols \
        + kps[:, 0].astype(int) // cell
    order = np.argsort(-scores)
    seen = set()
    for i in order:
        if not valid[i]:
            continue
        c = int(cid[i])
        if c not in seen:
            seen.add(c)
            keep[i] = True
    return keep


def kdt_nms(kps: np.ndarray, scores: np.ndarray, valid: np.ndarray,
            radius: float = 4.0) -> np.ndarray:
    """Greedy radius suppression in descending response order."""
    order = np.argsort(-scores)
    keep = np.zeros(len(kps), bool)
    kept_pts = []
    r2 = radius * radius
    for i in order:
        if not valid[i]:
            continue
        p = kps[i]
        if all((p[0] - q[0]) ** 2 + (p[1] - q[1]) ** 2 > r2
               for q in kept_pts):
            keep[i] = True
            kept_pts.append(p)
    return keep


def ssc_nms(kps: np.ndarray, scores: np.ndarray, valid: np.ndarray,
            H: int, W: int, k: int, tol: float = 0.1) -> np.ndarray:
    """Suppression-via-square-covering: binary-search the cell size so the
    survivor count lands within tol of k (adaptive NMS)."""
    idx = np.flatnonzero(valid)
    if len(idx) <= k:
        return valid.copy()
    lo, hi = 1.0, float(max(H, W))
    best = None
    for _ in range(20):
        mid = 0.5 * (lo + hi)
        keep = grid_nms(kps, scores, valid, H, W, cell=max(int(mid), 1))
        n = keep.sum()
        if abs(n - k) <= tol * k:
            return keep
        if n > k:
            lo = mid
        else:
            hi = mid
        best = keep
    return best if best is not None else valid.copy()


def octree_nms(kps: np.ndarray, scores: np.ndarray, valid: np.ndarray,
               H: int, W: int, k: int) -> np.ndarray:
    """Quadtree subdivision keeping the best keypoint per leaf until ~k
    leaves (the pyslam octree filter needed a C++ helper; this is the same
    policy in numpy)."""
    boxes = [(0.0, 0.0, float(W), float(H),
              np.flatnonzero(valid).tolist())]
    while len(boxes) < k:
        # split the box with the most keypoints
        boxes.sort(key=lambda b: -len(b[4]))
        if not boxes or len(boxes[0][4]) <= 1 or boxes[0][2] < 2:
            break
        x, y, w, h, ids = boxes[0]
        boxes = boxes[1:]
        hw, hh = w / 2, h / 2
        for dx, dy in ((0, 0), (hw, 0), (0, hh), (hw, hh)):
            sub = [i for i in ids
                   if x + dx <= kps[i, 0] < x + dx + hw
                   and y + dy <= kps[i, 1] < y + dy + hh]
            if sub:
                boxes.append((x + dx, y + dy, hw, hh, sub))
    keep = np.zeros(len(kps), bool)
    for *_, ids in boxes:
        if ids:
            keep[ids[int(np.argmax(scores[ids]))]] = True
    return keep
