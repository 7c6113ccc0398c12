"""Sparse map bookkeeping: map points, keyframes, covisibility.

A numpy-only copy of the JAX reference package's frontend/mapstore.py
(the port imports nothing of that package).

Capability of the reference's pyslam graft (src/map.py, src/map_point.py,
src/keyframe.py): a map of 3-D points observed by keyframes, with
  - MapPoint: observations, best-descriptor maintenance (min median
    descriptor distance, src/map_point.py:235-481), normal/view-distance
    stats, replacement;
  - KeyFrame: feature arrays + pose + per-keypoint map-point slots;
  - KeyFrameGraph: covisibility counters + spanning-tree parent
    (src/keyframe.py:35-143);
  - Map: add_keyframe/add_points (geometric gates live in
    frontend.triangulate.point_checks), reprojection-error culling
    (src/map.py:289-311), LocalWindowMap view (src/map.py:488-527).

The reference wraps these in RLocks for its two OS processes; the
single-controller engine touches them from one thread, so they are plain
Python structures (SURVEY §2.4 P8). Geometry stays batched/NumPy.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np


class MapPoint:
    _next_id = 0

    def __init__(self, position: np.ndarray, color=None):
        self.id = MapPoint._next_id
        MapPoint._next_id += 1
        self.pt = np.asarray(position, np.float64)
        self.color = color
        self.observations: Dict[int, int] = {}  # kf id -> keypoint index
        self.des: Optional[np.ndarray] = None   # best descriptor
        self._des_obs: List[np.ndarray] = []
        self.normal = np.zeros(3)
        self.min_dist = 0.0
        self.max_dist = np.inf
        self.is_bad = False
        self.num_observations = 0

    def add_observation(self, kf: "KeyFrame", kp_idx: int,
                        descriptor: Optional[np.ndarray] = None):
        if kf.id in self.observations:
            return False
        self.observations[kf.id] = kp_idx
        self.num_observations += 1
        if descriptor is not None:
            self._des_obs.append(np.asarray(descriptor))
            self._update_best_descriptor()
        self._update_normal(kf)
        kf.set_point(kp_idx, self)
        return True

    def remove_observation(self, kf: "KeyFrame"):
        idx = self.observations.pop(kf.id, None)
        if idx is not None:
            self.num_observations -= 1
            kf.set_point(idx, None)
        if self.num_observations <= 1:
            self.set_bad()

    def _update_best_descriptor(self):
        """Descriptor with min median distance to all others
        (src/map_point.py best-descriptor MAD update)."""
        if len(self._des_obs) <= 2:
            self.des = self._des_obs[-1]
            return
        D = np.stack(self._des_obs)
        sim = np.clip(D @ D.T, -1, 1)
        dist = np.sqrt(np.maximum(2 - 2 * sim, 0))
        med = np.median(dist, axis=1)
        self.des = self._des_obs[int(np.argmin(med))]

    def _update_normal(self, kf: "KeyFrame"):
        v = self.pt - kf.camera_center()
        d = np.linalg.norm(v)
        if d > 1e-9:
            n = self.num_observations
            self.normal = (self.normal * (n - 1) + v / d) / n
            nn = np.linalg.norm(self.normal)
            if nn > 1e-9:
                self.normal /= nn
            self.min_dist = 0.8 * d
            self.max_dist = 1.3 * d

    def replace_with(self, other: "MapPoint"):
        """Point fusion (src/map_point.py replacement)."""
        for kf_id, kp_idx in list(self.observations.items()):
            kf = _KF_REGISTRY.get(kf_id)
            if kf is not None and kf_id not in other.observations:
                other.add_observation(kf, kp_idx)
        self.set_bad()

    def set_bad(self):
        self.is_bad = True


_KF_REGISTRY: Dict[int, "KeyFrame"] = {}


class KeyFrame:
    _next_id = 0

    def __init__(self, frame_idx: int, kps: np.ndarray, desc: np.ndarray,
                 valid: np.ndarray, Tcw: np.ndarray, angles=None):
        self.id = KeyFrame._next_id
        KeyFrame._next_id += 1
        self.kid = self.id  # keyframe id in insertion order
        self.frame_idx = frame_idx
        self.kps = np.asarray(kps)
        self.desc = np.asarray(desc)
        self.valid = np.asarray(valid)
        # keypoint orientations (radians) — kept so later triangulation
        # partners can still run the rotation-histogram gate
        self.angles = None if angles is None else np.asarray(angles)
        self.Tcw = np.asarray(Tcw, np.float64)
        self.points: List[Optional[MapPoint]] = [None] * len(kps)
        self.is_bad = False
        _KF_REGISTRY[self.id] = self

    def camera_center(self) -> np.ndarray:
        return -self.Tcw[:3, :3].T @ self.Tcw[:3, 3]

    def set_point(self, kp_idx: int, mp: Optional[MapPoint]):
        self.points[kp_idx] = mp

    def tracked_points(self):
        return [p for p in self.points if p is not None and not p.is_bad]


class KeyFrameGraph:
    """Covisibility counters + spanning tree (src/keyframe.py:35-143)."""

    COVIS_MIN = 15  # kNumMinObsForKeyFrameDefault-ish edge threshold

    def __init__(self):
        self.keyframes: List[KeyFrame] = []
        self.covisibility: Dict[int, Dict[int, int]] = {}
        self.parent: Dict[int, Optional[int]] = {}

    def add(self, kf: KeyFrame):
        self.keyframes.append(kf)
        self.covisibility[kf.id] = {}
        self.update_connections(kf)

    def update_connections(self, kf: KeyFrame):
        counts: Dict[int, int] = {}
        for mp in kf.tracked_points():
            for other_id in mp.observations:
                if other_id != kf.id:
                    counts[other_id] = counts.get(other_id, 0) + 1
        self.covisibility[kf.id] = {
            k: v for k, v in counts.items() if v >= self.COVIS_MIN} or counts
        for other_id, c in self.covisibility[kf.id].items():
            self.covisibility.setdefault(other_id, {})[kf.id] = c
        if counts:
            self.parent[kf.id] = max(counts, key=counts.get)
        else:
            self.parent[kf.id] = None

    def get_covisible(self, kf: KeyFrame, n: Optional[int] = None):
        edges = sorted(self.covisibility.get(kf.id, {}).items(),
                       key=lambda kv: -kv[1])
        ids = [k for k, _ in edges[:n]]
        return [k for k in (_KF_REGISTRY.get(i) for i in ids)
                if k is not None and not k.is_bad]


class Map:
    """Thread-free map (src/map.py capability; locks dropped per SURVEY
    §2.4 P8 — single-controller engine)."""

    def __init__(self, max_frames: int = 20):
        self.frames = deque(maxlen=max_frames)
        self.graph = KeyFrameGraph()
        self.points: List[MapPoint] = []

    @property
    def keyframes(self):
        return self.graph.keyframes

    def add_keyframe(self, kf: KeyFrame):
        self.graph.add(kf)

    def add_points(self, pts3d: np.ndarray, accept_mask: np.ndarray,
                   kf_cur: KeyFrame, kf_ref: KeyFrame, idx_cur: np.ndarray,
                   idx_ref: np.ndarray, colors=None):
        """Register accepted triangulations as map points
        (src/map.py:191-287; the geometric gates are point_checks)."""
        new = 0
        for i in np.flatnonzero(accept_mask):
            mp = MapPoint(pts3d[i],
                          None if colors is None else colors[i])
            mp.add_observation(kf_cur, int(idx_cur[i]),
                               kf_cur.desc[int(idx_cur[i])])
            mp.add_observation(kf_ref, int(idx_ref[i]),
                               kf_ref.desc[int(idx_ref[i])])
            self.points.append(mp)
            new += 1
        return new

    def cull_points(self, max_reproj_err_n: float = 5e-3):
        """Drop points whose mean normalized reprojection error is large
        (src/map.py:289-311)."""
        kept = []
        removed = 0
        for mp in self.points:
            if mp.is_bad:
                removed += 1
                continue
            errs = []
            for kf_id, kp_idx in mp.observations.items():
                kf = _KF_REGISTRY.get(kf_id)
                if kf is None:
                    continue
                pc = kf.Tcw[:3, :3] @ mp.pt + kf.Tcw[:3, 3]
                if pc[2] <= 0:
                    errs.append(np.inf)
                    continue
                uvn = pc[:2] / pc[2]
                kpn = kf.kps[kp_idx]
                errs.append(np.linalg.norm(uvn - kpn))
            if errs and np.mean(errs) > max_reproj_err_n:
                mp.set_bad()
                removed += 1
            else:
                kept.append(mp)
        self.points = kept
        return removed

    def local_window(self, kf: KeyFrame, size: int = 5):
        """LocalWindowMap view (src/map.py:488-527): the kf + its most
        covisible neighbors and their points."""
        kfs = [kf] + self.graph.get_covisible(kf, size - 1)
        pts = {id(mp): mp for k in kfs for mp in k.tracked_points()}
        return kfs, list(pts.values())
