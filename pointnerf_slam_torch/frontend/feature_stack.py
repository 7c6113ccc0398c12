"""Pluggable feature stack (the JAX reference's frontend/feature_stack.py):
the pyslam-style manager / matcher / tracker API of the upstream
superpoint_manager.py (detector and keypoint-filter selection),
superpoint_matcher.py (matcher with ratio test and cross-check),
superpoint_tracker.py (the track(image_ref, image_cur) facade) and
feature_superpoint.py (a cv2.Feature2D-style detectAndCompute adapter).

Extraction and matching run in torch on the manager's device, the card
unless the caller asks for the CPU (frontend.features, frontend.matching);
the keypoint filters and the outputs are numpy (frontend.nms).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .features import HarrisExtractor, SuperPointExtractor
from .matching import match_two_way
from .nms import grid_nms, kdt_nms, octree_nms, ssc_nms


@dataclasses.dataclass
class FeatureManagerConfig:
    detector: str = "harris"          # 'harris' | 'superpoint'
    num_features: int = 1000
    keypoint_filter: str = "none"     # 'none'|'grid'|'kdt'|'ssc'|'octree'
    superpoint_weights: Optional[str] = None


class FeatureManager:
    """Detector and keypoint-filter selection."""

    def __init__(self, cfg: FeatureManagerConfig = FeatureManagerConfig(),
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.detector == "superpoint":
            self.extractor = SuperPointExtractor(
                cfg.superpoint_weights, max_kps=cfg.num_features,
                device=self.device)
        else:
            self.extractor = HarrisExtractor(max_kps=cfg.num_features)

    def detect_and_compute(self, img_gray: np.ndarray):
        """(kps (K,2), desc (K,D), valid (K,)) with the configured filter."""
        kps, desc, valid, _ = self.extractor.extract(torch.as_tensor(
            np.asarray(img_gray, np.float32), device=self.device))
        kps = kps.cpu().numpy()
        desc = desc.cpu().numpy()
        valid = valid.cpu().numpy()
        f = self.cfg.keypoint_filter
        if f != "none" and valid.any():
            H, W = img_gray.shape
            scores = -np.arange(len(kps), dtype=np.float64)  # top-k order
            if f == "grid":
                keep = grid_nms(kps, scores, valid, H, W)
            elif f == "kdt":
                keep = kdt_nms(kps, scores, valid)
            elif f == "ssc":
                keep = ssc_nms(kps, scores, valid, H, W,
                               self.cfg.num_features // 2)
            elif f == "octree":
                keep = octree_nms(kps, scores, valid, H, W,
                                  self.cfg.num_features // 2)
            else:
                raise ValueError(f)
            valid = valid & keep
        return kps, desc, valid


class SuperPointFeature2D:
    """cv2.Feature2D-style adapter."""

    def __init__(self, manager: Optional[FeatureManager] = None,
                 device=None):
        self.manager = manager or FeatureManager(
            FeatureManagerConfig(detector="harris"), device=device)

    def detectAndCompute(self, img, mask=None):  # noqa: N802 (cv2 API)
        gray = img if img.ndim == 2 else img.mean(-1)
        kps, desc, valid = self.manager.detect_and_compute(
            np.asarray(gray, np.float32))
        return kps[valid], desc[valid]

    def detect(self, img, mask=None):
        return self.detectAndCompute(img, mask)[0]


@dataclasses.dataclass
class MatcherConfig:
    ratio_test: Optional[float] = None   # Lowe ratio (None = off)
    cross_check: bool = True             # mutual-NN
    nn_thresh: float = 0.7


def _dist_matrix(desc1: np.ndarray, desc2: np.ndarray,
                 v2: np.ndarray) -> np.ndarray:
    sim = np.clip(desc1 @ desc2.T, -1, 1)
    d = np.sqrt(np.maximum(2 - 2 * sim, 0))
    d[:, ~v2] = 1e6
    return d


class FeatureMatcher:
    """Matcher: the upstream BF/FLANN variants as one dense product with an
    optional ratio test and cross-check."""

    def __init__(self, cfg: MatcherConfig = MatcherConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def match(self, desc1: np.ndarray, desc2: np.ndarray,
              valid1=None, valid2=None):
        """Returns (idx1, idx2) match index arrays."""
        v1 = np.ones(len(desc1), bool) if valid1 is None else valid1
        v2 = np.ones(len(desc2), bool) if valid2 is None else valid2
        dev = self.device
        idx2, mvalid, _ = match_two_way(
            torch.as_tensor(np.asarray(desc1, np.float32), device=dev),
            torch.as_tensor(np.asarray(v1), device=dev),
            torch.as_tensor(np.asarray(desc2, np.float32), device=dev),
            torch.as_tensor(np.asarray(v2), device=dev), self.cfg.nn_thresh)
        idx2 = idx2.cpu().numpy()
        mvalid = mvalid.cpu().numpy()
        if not self.cfg.cross_check:
            # nearest neighbour below the threshold, no mutual check
            d = _dist_matrix(desc1, desc2, v2)
            idx2 = d.argmin(1)
            mvalid = v1 & (d[np.arange(len(desc1)), idx2]
                           < self.cfg.nn_thresh)
        if self.cfg.ratio_test is not None:
            part = np.partition(_dist_matrix(desc1, desc2, v2), 1, axis=1)
            mvalid = mvalid & (part[:, 0] < self.cfg.ratio_test * part[:, 1])
        idx1 = np.flatnonzero(mvalid)
        return idx1, idx2[mvalid]


class FeatureTracker:
    """track(image_ref, image_cur) facade."""

    def __init__(self, manager: Optional[FeatureManager] = None,
                 matcher: Optional[FeatureMatcher] = None, device=None):
        self.manager = manager or FeatureManager(device=device)
        self.matcher = matcher or FeatureMatcher(device=device)

    def track(self, image_ref, image_cur, kps_ref=None, des_ref=None):
        gray_r = image_ref if image_ref.ndim == 2 else image_ref.mean(-1)
        gray_c = image_cur if image_cur.ndim == 2 else image_cur.mean(-1)
        if kps_ref is None or des_ref is None:
            kr, dr, vr = self.manager.detect_and_compute(
                np.asarray(gray_r, np.float32))
            kps_ref, des_ref = kr[vr], dr[vr]
        kc, dc, vc = self.manager.detect_and_compute(
            np.asarray(gray_c, np.float32))
        kps_cur, des_cur = kc[vc], dc[vc]
        i1, i2 = self.matcher.match(des_ref, des_cur)
        return {
            "kps_ref": kps_ref, "des_ref": des_ref,
            "kps_cur": kps_cur, "des_cur": des_cur,
            "idxs_ref": i1, "idxs_cur": i2,
            "kps_ref_matched": kps_ref[i1],
            "kps_cur_matched": kps_cur[i2],
        }
