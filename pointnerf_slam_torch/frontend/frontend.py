"""Sparse visual front-end: pose initialization and pseudo-depth (the JAX
reference's frontend/frontend.py, `SparseFrontend`).

  extract keypoints -> two-way NN match -> E-matrix RANSAC pose ->
  two-view triangulation -> baseline scale -> reproject -> patch splat
  into pseudo-depth maps,

with the reference's reference-keyframe policy (hold the two-view
reference until the parallax is adequate), the persistent sparse map
(map-point registration, association, culling, confirmed-point
projections), the map-anchored and scale-sanity corrections, the
motion-plausibility gates and the gap-aware parallax expectation. The
device work (extraction, the two-view step, splats) runs in torch on the
system's device; the map bookkeeping is numpy on the host, as in the
reference.

Coordinate bridge: the field uses the OpenGL-style camera (-y, -z); the
epipolar geometry runs in the CV convention (+z forward):
Tcw_cv = F4 @ inv(c2w_nerf), F4 = diag(1, -1, -1, 1).

Random draws: the RANSAC hypotheses of each solve come from `draws`
(engine/state.Draws; a torch generator seeded 7 by default, the reference
splits PRNGKey(7) per solve), so tests can replay the reference's draws.

Matched, not fixed (ROADMAP Queue 3): the three behaviours the reference's
ADVICE.md flags (the step-history and map-overflow policies and the
post-advance hold) behave here as in the reference.

Checkpoint state: `state_arrays` / `load_state_arrays` save and restore
the reference keyframe with its features, the keyframe window, the
persistent map and the counters as flat arrays under the reference's
`fe2_*` keys, so either package resumes from the other's checkpoint.

`pseudo_depth_for` triangulates a frame at known poses (no E solve)
against the previous tracked frame, or an older cached keyframe with the
persistent map on; no engine path calls it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..engine.state import Draws
from .features import HarrisExtractor, SuperPointExtractor
from .mapstore import _KF_REGISTRY, KeyFrame, Map, MapPoint
from .matching import match_two_way
from .pseudo_depth import splat_pseudo_depth
from .triangulate import point_checks, triangulate_points

_F4 = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def compute_pose_error(T_rel_est: np.ndarray, T_rel_gt: np.ndarray):
    """Translation-direction angle (folded at 180 deg for the E sign
    ambiguity) and rotation angle between two relative poses, degrees."""
    t = T_rel_est[:3, 3]
    t_gt = T_rel_gt[:3, 3]
    n = np.linalg.norm(t) * np.linalg.norm(t_gt)
    err_t = np.degrees(np.arccos(np.clip(t @ t_gt / max(n, 1e-12), -1, 1)))
    err_t = min(err_t, 180.0 - err_t)
    cos = (np.trace(T_rel_est[:3, :3].T @ T_rel_gt[:3, :3]) - 1) / 2
    err_r = np.degrees(np.abs(np.arccos(np.clip(cos, -1.0, 1.0))))
    return float(err_t), float(err_r)


def _inv_rigid_np(T: np.ndarray) -> np.ndarray:
    R = T[:3, :3]
    t = T[:3, 3]
    out = np.eye(4, dtype=np.float64)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def nerf_c2w_to_cv_w2c(c2w_nerf: np.ndarray) -> np.ndarray:
    return _F4 @ _inv_rigid_np(np.asarray(c2w_nerf, np.float64))


def cv_w2c_to_nerf_c2w(Tcw_cv: np.ndarray) -> np.ndarray:
    return _inv_rigid_np(_F4 @ np.asarray(Tcw_cv, np.float64))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class SparseFrontend:
    def __init__(self, cfg, H, W, fx, fy, cx, cy, device="cpu",
                 extractor=None, draws: Optional[Draws] = None):
        self.H, self.W = H, W
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.device = torch.device(device)
        self.depth_patch = cfg.get("depth_patch", 5)
        self.nn_thresh = cfg.get("nn_thresh", 0.7)
        self.max_kps = cfg.get("num_features", 1000)
        self.bundle_loss = cfg.get("bundle_loss", True)
        self.ransac_thresh = cfg.get("ransac_thresh",
                                     max(3e-4, 1.0 / float(fx)))
        self.draws = draws if draws is not None else Draws(
            torch.Generator(device=self.device).manual_seed(7))
        self.extractor = extractor if extractor is not None \
            else self._default_extractor(cfg, H, W)
        self.depth_scale: Optional[float] = None
        self.median_gt_depth: Optional[float] = None
        self.kp_depth_ratio0: Optional[float] = None
        self.prev = None        # reference keyframe: dict(frame_idx, feats)
        self.telemetry = []
        self._step_hist: list = []
        self._last_tracked_idx: Optional[int] = None
        self.min_parallax_deg = float(cfg.get("min_parallax_deg", 1.5))
        self.ref_advance_parallax_deg = float(
            cfg.get("ref_advance_parallax_deg", 2.5))
        self.ref_min_matches = int(cfg.get("ref_min_matches", 150))
        self.ref_min_inliers = int(cfg.get("ref_min_inliers", 60))
        self.ref_max_fail = int(cfg.get("ref_max_fail", 2))
        self._ref_fail_count = 0
        # gap-aware parallax expectation: deg/frame from conditioned solves
        self._par_rate: Optional[float] = None
        self.par_rate_min_gap = int(cfg.get("par_rate_min_gap", 10))
        self.ref_max_reject = int(cfg.get("ref_max_reject", 3))
        self._reject_count = 0
        self.use_map = bool(cfg.get("map_points", True))
        self.map = Map(max_frames=cfg.get("map_max_frames", 20)) \
            if self.use_map else None
        self.map_proj_budget = int(cfg.get("map_proj_budget", 2048))
        self.map_cull_every = int(cfg.get("map_cull_every", 5))
        self.map_max_points = int(cfg.get("map_max_points", 12000))
        self.map_scale_anchor = bool(cfg.get("map_scale_anchor", True))
        self.map_scale_min_pts = int(cfg.get("map_scale_min_pts", 10))
        self.bootstrap_min_parallax_deg = float(
            cfg.get("bootstrap_min_parallax_deg", 2.0))
        self.bootstrap_min_cand = int(cfg.get("bootstrap_min_cand", 50))
        self.max_step_depth_frac = float(
            cfg.get("max_step_depth_frac", 0.15))
        self._kfs = {}
        self._kf_order = []
        self._feat_cache = {}
        self.last_debug = None
        self._runners = {}
        self.dyn = None
        if cfg.get("dyn_matching", True):
            from .dyn_config import SLAMDynamicConfig
            self.dyn = SLAMDynamicConfig(
                max_descriptor_distance=self.nn_thresh)
        self.check_orientation = bool(cfg.get("check_orientation", True))

    def _default_extractor(self, cfg, H, W):
        """The reference's rule: SuperPoint when the checkpoint that
        `superpoint_weights` names exists (a .pth state dict or the shared
        .npz; default the public pretrained/superpoint_v1.pth) and the
        image divides the 8x8 cell grid, else Harris
        (`superpoint_weights: none` forces Harris)."""
        sp_cfg = cfg.get("superpoint_weights",
                         "pretrained/superpoint_v1.pth")
        if str(sp_cfg).lower() in ("none", "off", "false") \
                or H % 8 or W % 8:
            return HarrisExtractor(max_kps=self.max_kps)
        if os.path.exists(str(sp_cfg)):
            return SuperPointExtractor(str(sp_cfg), max_kps=self.max_kps,
                                       device=self.device)
        return HarrisExtractor(max_kps=self.max_kps)

    # -- helpers -----------------------------------------------------------
    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=self.device)

    def _extract(self, color_np):
        gray = torch.as_tensor(np.asarray(color_np), dtype=torch.float32,
                               device=self.device).mean(-1)
        return self.extractor.extract(gray)

    def _kpn(self, kps: torch.Tensor) -> torch.Tensor:
        return torch.stack([(kps[:, 0] - self.cx) / self.fx,
                            (kps[:, 1] - self.cy) / self.fy], -1)

    def prefetch_extract(self, frame_reader, idx: int):
        """Read and extract a future tracked frame's features right after
        the mapper is dispatched, so they are ready when its turn comes."""
        if idx in self._feat_cache:
            return
        _, color, _, _ = frame_reader[idx]
        self._feat_cache.clear()
        self._feat_cache[idx] = self._extract(color)

    # -- core two-view procedure -------------------------------------------
    def _runner_for(self, mode: str, field_ctx=None):
        if mode not in self._runners:
            from .fused_twoview import TwoViewRunner
            self._runners[mode] = TwoViewRunner(
                self.H, self.W, self.fx, self.fy, self.cx, self.cy,
                self.nn_thresh, self.ransac_thresh,
                rcfg=field_ctx.get("rcfg") if field_ctx else None,
                bundle_loss=self.bundle_loss,
                check_orientation=self.check_orientation)
        return self._runners[mode]

    def _two_view(self, feats_ref, feats_cur, Tcw_ref_cv: np.ndarray,
                  set_scale: bool, field_ctx=None, scale_prior=None):
        """One two-view solve (fused_twoview.TwoViewRunner.run). set_scale
        (bootstrap) anchors depth_scale to the gt median depth; otherwise
        scale_prior is the carried scale the field anchor is clamped
        against and blended with."""
        mode = "bootstrap" if set_scale else (
            "field" if field_ctx is not None else "continuous")
        kw = {}
        if mode == "field":
            kw = dict(decoder=field_ctx["decoder"],
                      c2w_pred=field_ctx["c2w_pred"],
                      bound=field_ctx["bound"])
        r = self._runner_for(mode, field_ctx).run(
            mode, feats_ref, feats_cur, Tcw_ref_cv, self.draws,
            self.median_gt_depth,
            scale_prior if scale_prior is not None else self.depth_scale,
            nn_thresh=(self.dyn.max_descriptor_distance
                       if self.dyn is not None else None), **kw)
        if self.dyn is not None:
            self.dyn.update_descriptor_stats(r["score_med"],
                                             r["score_mad"])
        if set_scale:
            if r["n_cand"] < max(self.bootstrap_min_cand, 8):
                raise RuntimeError(
                    f"frontend bootstrap: only {r['n_cand']} accepted "
                    f"triangulations")
            if float(r["parallax"]) < self.bootstrap_min_parallax_deg:
                raise RuntimeError(
                    f"frontend bootstrap: parallax "
                    f"{float(r['parallax']):.2f} deg below "
                    f"{self.bootstrap_min_parallax_deg} (structure would "
                    f"be noise; waiting for baseline)")
            self.depth_scale = r["scale"]
        return r

    def _splat(self, uv, z, accept):
        return splat_pseudo_depth(
            self._dev(uv), self._dev(z),
            torch.as_tensor(np.asarray(accept), device=self.device),
            self.H, self.W, self.depth_patch)

    def _map_scale_correction(self, ref_idx, Tcw_ref_cv, r):
        """Median ratio of confirmed map points' depth in the reference
        camera to the pair's triangulated depth there. Returns (f, n)."""
        kf_ref = self._kfs.get(ref_idx)
        if kf_ref is None or self.map is None:
            return 1.0, 0
        obs = {}
        for mp in self.map.points:
            if mp.is_bad or len(mp.observations) < 2:
                continue
            j = mp.observations.get(kf_ref.id)
            if j is not None:
                obs[int(j)] = mp
        if not obs:
            return 1.0, 0
        Rr = Tcw_ref_cv[:3, :3]
        tr = Tcw_ref_cv[:3, 3]
        idx2, z_ref = r["idx2"], r["z_ref"]

        def _ratios(mask):
            out = []
            for i in np.flatnonzero(mask):
                mp = obs.get(int(idx2[i]))
                if mp is None:
                    continue
                z_tri = float(z_ref[i])
                z_map = float(Rr[2] @ mp.pt + tr[2])
                if z_tri > 1e-3 and z_map > 1e-3:
                    out.append(z_map / z_tri)
            return out

        ratios = _ratios(r["accept"])
        if len(ratios) < self.map_scale_min_pts:
            ratios = _ratios(np.asarray(r.get("cand", z_ref > 1e-3))
                             & (np.asarray(z_ref) > 1e-3))
        if len(ratios) < self.map_scale_min_pts:
            return 1.0, len(ratios)
        return float(np.median(ratios)), len(ratios)

    def _kf_for(self, frame_idx, kpn_full, desc, valid, Tcw_cv,
                angles=None):
        """Get-or-create the bounded-window KeyFrame of a frame."""
        kf = self._kfs.get(frame_idx)
        if kf is None:
            kf = KeyFrame(frame_idx, _np(kpn_full), _np(desc), _np(valid),
                          np.asarray(Tcw_cv),
                          angles=None if angles is None else _np(angles))
            self._kfs[frame_idx] = kf
            self._kf_order.append(frame_idx)
            self.map.add_keyframe(kf)
            while len(self._kf_order) > self.map.frames.maxlen:
                old = self._kf_order.pop(0)
                old_kf = self._kfs.pop(old)
                old_kf.is_bad = True
                _KF_REGISTRY.pop(old_kf.id, None)
        return kf

    def _map_update(self, idx, kf_cur, kf_ref, idx2, pts3d, accept,
                    Tcw_cur_cv):
        """Persistent-map bookkeeping: associate accepted keypoints with
        alive map points (fuse) or create new points, cull, cap, and
        return up to map_proj_budget projections of confirmed points."""
        alive = [mp for mp in self.map.points if not mp.is_bad]
        kpn = kf_cur.kps
        u_kp = kpn[:, 0] * self.fx + self.cx
        v_kp = kpn[:, 1] * self.fy + self.cy

        u = v = z = None
        if alive:
            pts = np.stack([mp.pt for mp in alive])
            pc = pts @ Tcw_cur_cv[:3, :3].T + Tcw_cur_cv[:3, 3]
            z = pc[:, 2]
            front = z > 1e-3
            u = pc[:, 0] / np.maximum(z, 1e-6) * self.fx + self.cx
            v = pc[:, 1] / np.maximum(z, 1e-6) * self.fy + self.cy
            inside = front & (u >= 0) & (u < self.W) & (v >= 0) \
                & (v < self.H)

        assoc_px = 2.5
        new_mask = np.array(accept, copy=True)
        if alive:
            cand = np.flatnonzero(inside)
            if len(cand):
                du = u[cand][None, :] - u_kp[:, None]
                dv = v[cand][None, :] - v_kp[:, None]
                d2 = du * du + dv * dv
                best = np.argmin(d2, axis=1)
                near = d2[np.arange(len(kpn)), best] < assoc_px ** 2
                for i in np.flatnonzero(np.asarray(accept) & near):
                    mp = alive[cand[best[i]]]
                    desc_i = kf_cur.desc[i]
                    if mp.des is not None and np.linalg.norm(
                            mp.des - desc_i) < self.nn_thresh:
                        mp.add_observation(kf_cur, int(i), desc_i)
                        new_mask[i] = False
        self.map.add_points(np.asarray(pts3d), new_mask, kf_cur, kf_ref,
                            np.arange(len(new_mask)), np.asarray(idx2))

        if len(self._kf_order) % self.map_cull_every == 0:
            self.map.cull_points(max_reproj_err_n=2.0 / float(self.fx))
        if len(self.map.points) > self.map_max_points:
            order = np.argsort([-mp.num_observations
                                for mp in self.map.points], kind="stable")
            keep = set(order[:self.map_max_points].tolist())
            for i, mp in enumerate(self.map.points):
                if i not in keep:
                    mp.set_bad()
            self.map.points = [self.map.points[i] for i in sorted(keep)]

        B = self.map_proj_budget
        uv_m = np.zeros((B, 2), np.float32)
        z_m = np.zeros((B,), np.float32)
        acc_m = np.zeros((B,), bool)
        if alive:
            nobs = np.array([len(mp.observations) for mp in alive])
            zmin = 0.05 * (self.median_gt_depth or 1.0)
            sel = np.flatnonzero(inside & (nobs >= 3) & (z > zmin))
            if len(sel) > B:
                sel = sel[np.argsort(-nobs[sel], kind="stable")[:B]]
            k = len(sel)
            uv_m[:k, 0] = u[sel]
            uv_m[:k, 1] = v[sel]
            z_m[:k] = z[sel]
            acc_m[:k] = True
        return uv_m, z_m, acc_m

    # -- public API ----------------------------------------------------------
    def bootstrap(self, frame_reader, ref_idx: int, cur_idx: int,
                  ref_c2w_nerf: np.ndarray):
        """Initial two-view bootstrap. Returns (est_c2w_cur (4, 4) NeRF
        convention, pseudo_ref, pseudo_cur (H, W) device tensors).
        Raises RuntimeError when the pair is not conditioned yet."""
        _, color_ref, depth_ref, _ = frame_reader[ref_idx]
        _, color_cur, _, _ = frame_reader[cur_idx]
        if self.median_gt_depth is None:
            z = np.sort(np.asarray(depth_ref).reshape(-1))
            self.median_gt_depth = float(z[(len(z) - 1) // 2])

        feats_ref = self._extract(color_ref)
        feats_cur = self._extract(color_cur)
        Tcw_ref_cv = nerf_c2w_to_cv_w2c(ref_c2w_nerf)

        r = self._two_view(feats_ref, feats_cur, Tcw_ref_cv, set_scale=True)
        Tcw_cur_cv, uv_cur, uv_ref = r["Tcw_cur"], r["uv_cur"], r["uv_ref"]
        z_cur, z_ref, accept = r["z_cur"], r["z_ref"], r["accept"]

        # keypoint-located metric anchor: the ref depth at the accepted
        # keypoints' pixels against their triangulated depth
        d_ref_np = np.asarray(depth_ref)
        zr_np = np.asarray(z_ref)
        u_px = np.clip(np.round(np.asarray(uv_ref[:, 0])).astype(int),
                       0, self.W - 1)
        v_px = np.clip(np.round(np.asarray(uv_ref[:, 1])).astype(int),
                       0, self.H - 1)
        gtz = d_ref_np[v_px, u_px]
        m = np.asarray(accept) & (zr_np > 1e-3) & (gtz > 1e-3)
        if int(m.sum()) >= 20:
            f0 = float(np.clip(np.median(gtz[m] / zr_np[m]), 0.5, 2.0))
            C_ref = _inv_rigid_np(Tcw_ref_cv)[:3, 3]
            Twc_cur = _inv_rigid_np(Tcw_cur_cv)
            Twc_cur[:3, 3] = C_ref + f0 * (Twc_cur[:3, 3] - C_ref)
            Tcw_cur_cv = _inv_rigid_np(Twc_cur)
            z_cur = np.asarray(z_cur) * f0
            z_ref = zr_np * f0
            self.depth_scale = float(self.depth_scale) * f0
            self.telemetry_f0 = f0
        zr_fin = np.asarray(z_ref)
        zr_fin = zr_fin[np.asarray(accept) & (zr_fin > 1e-3)]
        if len(zr_fin) >= 20 and self.median_gt_depth:
            self.kp_depth_ratio0 = float(
                np.median(zr_fin) / self.median_gt_depth)

        self.telemetry.append({
            "idx": cur_idx, "n_matches": r["n_matches"],
            "n_inliers": r["n_inliers"], "n_accept": r["n_accept"],
            "scale": r["scale"]})

        pseudo_ref = self._splat(uv_ref, z_ref, accept)
        pseudo_cur = self._splat(uv_cur, z_cur, accept)
        self.last_debug = {"ref_idx": ref_idx, "cur_idx": cur_idx,
                           "kps_ref": np.asarray(uv_ref),
                           "kps_cur": np.asarray(uv_cur),
                           "accept": np.asarray(accept)}
        self.prev = {"frame_idx": cur_idx, "feats": feats_cur}
        self._last_tracked_idx = cur_idx
        bs_par = float(r["parallax"])
        if np.isfinite(bs_par) and bs_par > 0:
            self._par_rate = bs_par / max(cur_idx - ref_idx, 1)
        if self.map is not None:
            self._map_register_from_feats(
                cur_idx, feats_cur, ref_idx, feats_ref,
                np.asarray(Tcw_cur_cv), Tcw_ref_cv)
        return cv_w2c_to_nerf_c2w(Tcw_cur_cv), pseudo_ref, pseudo_cur

    def _map_register_from_feats(self, idx_c, feats_c, idx_r, feats_r,
                                 Tcw_c, Tcw_r):
        """Match, triangulate, gate and register a frame pair into the
        persistent map (bootstrap seeding)."""
        kps_c, desc_c, val_c, ang_c = feats_c
        kps_r, desc_r, val_r, ang_r = feats_r
        idx2, mvalid, _ = match_two_way(desc_c, val_c, desc_r, val_r,
                                        self.nn_thresh)
        if self.check_orientation:
            from .rotation_histogram import \
                filter_matches_with_histogram_orientation
            mvalid = filter_matches_with_histogram_orientation(
                ang_r[idx2], ang_c, mvalid, min_keep=16, min_frac=0.7)
        kpn_c = self._kpn(kps_c)
        kpn_r_full = self._kpn(kps_r)
        Tc, Tr = self._dev(Tcw_c), self._dev(Tcw_r)
        pts3d, ok = triangulate_points(Tc, Tr, kpn_c, kpn_r_full[idx2])
        acc, z_c, _, _, _ = point_checks(pts3d, Tc, Tr, kpn_c,
                                         kpn_r_full[idx2], self.fx,
                                         max_reproj_px=3.0)
        accept = _np(acc & mvalid & ok)
        if self.median_gt_depth is not None:
            zc = _np(z_c)
            accept = accept & (zc > 0.25 * self.median_gt_depth) \
                & (zc < 4.0 * self.median_gt_depth)
        kf_r = self._kf_for(idx_r, kpn_r_full, desc_r, val_r, Tcw_r,
                            angles=ang_r)
        kf_c = self._kf_for(idx_c, kpn_c, desc_c, val_c, Tcw_c,
                            angles=ang_c)
        self._map_update(idx_c, kf_c, kf_r, _np(idx2), _np(pts3d), accept,
                         Tcw_c)

    def _note_rejection(self, idx: int, feats_cur) -> None:
        """Count a plausibility-gate rejection toward reference staleness;
        re-anchor on the current frame after ref_max_reject in a row."""
        self._reject_count += 1
        if self._reject_count >= self.ref_max_reject:
            self.prev = {"frame_idx": idx, "feats": feats_cur}
            self._reject_count = 0
            self._ref_fail_count = 0

    def track_continuous(self, frame_reader, idx: int,
                         estimate_c2w_list: np.ndarray,
                         field_ctx=None, gt_baseline=None):
        """Continuous tracked frame: a full two-view solve against the
        held reference keyframe, the motion-model baseline prior (the
        engine wrote the predicted pose of idx into estimate_c2w_list),
        map-anchored and scale-sanity corrections, parallax-gated
        pseudo-depth, map bookkeeping, reference advancement.
        Returns (est_c2w_nerf (4, 4) | None, pseudo_depth | None)."""
        if self.prev is None:
            return None, None
        feats_cur = self._feat_cache.pop(idx, None)
        if feats_cur is None:
            _, color_cur, _, _ = frame_reader[idx]
            feats_cur = self._extract(color_cur)
        ref_idx = self.prev["frame_idx"]
        feats_ref = self.prev["feats"]
        Tcw_ref_cv = nerf_c2w_to_cv_w2c(estimate_c2w_list[ref_idx])
        s_prior = max(float(np.linalg.norm(
            estimate_c2w_list[idx][:3, 3]
            - estimate_c2w_list[ref_idx][:3, 3])), 1e-4)
        if self._step_hist:
            s_prior = max(s_prior,
                          0.8 * float(np.median(self._step_hist)))
        r = self._two_view(feats_ref, feats_cur, Tcw_ref_cv,
                           set_scale=False, field_ctx=field_ctx,
                           scale_prior=s_prior)
        Tcw_cur_cv, uv_cur, uv_ref = r["Tcw_cur"], r["uv_cur"], r["uv_ref"]
        z_cur, accept = r["z_cur"], r["accept"]
        parallax = float(r["parallax"])
        gap = max(idx - ref_idx, 1)
        par_exp = self._par_rate * gap if self._par_rate else None
        par_eff = min(parallax, par_exp) if par_exp else parallax
        self.telemetry.append({
            "idx": idx, "ref_idx": ref_idx, "n_matches": r["n_matches"],
            "n_inliers": r["n_inliers"], "n_cand": r["n_cand"],
            "n_scale_ok": r["n_scale_ok"], "n_field_ok": r["n_field_ok"],
            "n_accept": int(accept.sum()), "scale": r["scale"],
            "scale_raw": r["scale_raw"],
            "s_prior": s_prior, "parallax": parallax,
            "par_eff": par_eff})
        self.last_debug = {"ref_idx": ref_idx, "cur_idx": idx,
                           "kps_ref": uv_ref, "kps_cur": uv_cur,
                           "accept": accept}
        est_c2w = cv_w2c_to_nerf_c2w(Tcw_cur_cv) \
            if r["n_inliers"] >= 8 else None

        if est_c2w is not None and par_eff < self.min_parallax_deg:
            # unconditioned: keep the rotation, hold the centre at the
            # motion-model prediction
            est_c2w = np.array(est_c2w, np.float64, copy=True)
            est_c2w[:3, 3] = estimate_c2w_list[idx][:3, 3]
            Tcw_cur_cv = nerf_c2w_to_cv_w2c(est_c2w)
        elif est_c2w is not None and self.map_scale_anchor:
            f, n_sup = self._map_scale_correction(ref_idx, Tcw_ref_cv, r)
            if n_sup >= self.map_scale_min_pts and np.isfinite(f):
                f = float(np.clip(f, 0.4, 2.5))
                trusted = (0.75 < f < 1.33) \
                    or (0.45 < f < 2.2 and n_sup >= 60) \
                    or n_sup >= 200
                if trusted:
                    C_ref = estimate_c2w_list[ref_idx][:3, 3]
                    est_c2w = np.array(est_c2w, np.float64, copy=True)
                    est_c2w[:3, 3] = C_ref + f * (est_c2w[:3, 3] - C_ref)
                    Tcw_cur_cv = nerf_c2w_to_cv_w2c(est_c2w)
                    z_cur = np.asarray(z_cur) * f
                    r["scale"] = float(r["scale"]) * f
                    self.telemetry[-1]["f_map"] = f
                    self.telemetry[-1]["n_map_anchor"] = n_sup

        if est_c2w is not None and self.median_gt_depth is not None \
                and self.kp_depth_ratio0 is not None \
                and par_eff >= self.min_parallax_deg \
                and gt_baseline is None:
            # scale-sanity restoring force against the bootstrap-calibrated
            # keypoint-vs-image median depth
            zfin = np.asarray(z_cur)
            zfin = zfin[np.asarray(r["cand"]) & (zfin > 1e-3)]
            if len(zfin) >= 30:
                m_med = float(np.median(zfin)) / (
                    self.median_gt_depth * self.kp_depth_ratio0)
                if m_med > 2.0 or m_med < 0.5:
                    f_s = 1.0 / m_med
                    C_ref = estimate_c2w_list[ref_idx][:3, 3]
                    est_c2w = np.array(est_c2w, np.float64, copy=True)
                    est_c2w[:3, 3] = C_ref + f_s * (est_c2w[:3, 3] - C_ref)
                    Tcw_cur_cv = nerf_c2w_to_cv_w2c(est_c2w)
                    z_cur = np.asarray(z_cur) * f_s
                    r["scale"] = float(r["scale"]) * f_s
                    self.telemetry[-1]["f_sanity"] = f_s

        if est_c2w is not None and gt_baseline is not None:
            # oracle-scale ablation (tracking.gt_scale_injection)
            C_ref = estimate_c2w_list[ref_idx][:3, 3]
            b = float(np.linalg.norm(est_c2w[:3, 3] - C_ref))
            if b > 1e-9:
                f_gt = float(gt_baseline) / b
                est_c2w = np.array(est_c2w, np.float64, copy=True)
                est_c2w[:3, 3] = C_ref + f_gt * (est_c2w[:3, 3] - C_ref)
                Tcw_cur_cv = nerf_c2w_to_cv_w2c(est_c2w)
                z_cur = np.asarray(z_cur) * f_gt
                r["scale"] = float(r["scale"]) * f_gt
                self.telemetry[-1]["f_gt"] = f_gt

        if est_c2w is None:
            self._ref_fail_count += 1
            if self._ref_fail_count >= self.ref_max_fail:
                self.prev = {"frame_idx": idx, "feats": feats_cur}
                self._ref_fail_count = 0
                self._reject_count = 0
            self._last_tracked_idx = idx
            return None, None
        self._ref_fail_count = 0

        # motion-plausibility gates, against the previous tracked frame
        last_tr = self._last_tracked_idx
        C_last = estimate_c2w_list[last_tr][:3, 3] if last_tr is not None \
            else estimate_c2w_list[ref_idx][:3, 3]
        step_d = float(np.linalg.norm(est_c2w[:3, 3] - C_last))
        self._last_tracked_idx = idx
        if self.median_gt_depth is not None and step_d > \
                self.max_step_depth_frac * self.median_gt_depth:
            self.telemetry.append({
                "idx": idx, "rejected_step_abs": step_d,
                "scale": r["scale"]})
            self._note_rejection(idx, feats_cur)
            return None, None
        if len(self._step_hist) >= 3:
            med = float(np.median(self._step_hist))
            if step_d > max(6.0 * med, 1e-3):
                self.telemetry.append({
                    "idx": idx, "rejected_step": step_d,
                    "step_median": med, "scale": r["scale"]})
                self._note_rejection(idx, feats_cur)
                return None, None
        self._step_hist.append(step_d)
        if len(self._step_hist) > 10:
            self._step_hist.pop(0)
        self.telemetry[-1]["step_d"] = step_d
        self.depth_scale = float(r["scale"])
        self._reject_count = 0
        if gap >= self.par_rate_min_gap and 0.0 < parallax < 10.0:
            rate = parallax / gap
            self._par_rate = rate if not self._par_rate \
                else 0.7 * self._par_rate + 0.3 * rate

        # pseudo-depth and map registration only from conditioned geometry
        emit = par_eff >= self.min_parallax_deg
        pseudo = None
        if emit:
            if self.map is not None:
                kf_ref = self._kf_for(ref_idx, self._kpn(feats_ref[0]),
                                      feats_ref[1], feats_ref[2],
                                      Tcw_ref_cv, angles=feats_ref[3])
                kf_cur = self._kf_for(idx, self._kpn(feats_cur[0]),
                                      feats_cur[1], feats_cur[2],
                                      Tcw_cur_cv, angles=feats_cur[3])
                Twc = _inv_rigid_np(Tcw_cur_cv)
                xn = (uv_cur - [self.cx, self.cy]) / [self.fx, self.fy]
                cam_pts = np.concatenate(
                    [xn * z_cur[:, None], z_cur[:, None]], 1)
                pts3d_w = cam_pts @ Twc[:3, :3].T + Twc[:3, 3]
                uv_m, z_m, acc_m = self._map_update(
                    idx, kf_cur, kf_ref, r["idx2"], pts3d_w, accept,
                    np.asarray(Tcw_cur_cv))
                uv_all = np.concatenate([uv_cur, uv_m], axis=0)
                z_all = np.concatenate([z_cur, z_m], axis=0)
                acc_all = np.concatenate([accept, acc_m], axis=0)
            else:
                uv_all, z_all, acc_all = uv_cur, z_cur, accept
            if int(acc_all.sum()) >= 8:
                pseudo = self._splat(uv_all, z_all, acc_all)

        # reference advancement: past the advance parallax, or when
        # matching against the reference decays
        if (par_eff >= self.ref_advance_parallax_deg
                and int(accept.sum()) >= 16) \
                or r["n_matches"] < self.ref_min_matches \
                or r["n_inliers"] < self.ref_min_inliers:
            self.prev = {"frame_idx": idx, "feats": feats_cur}
        return est_c2w, pseudo

    def pseudo_depth_for(self, frame_reader, idx: int,
                         estimate_c2w_list: np.ndarray,
                         cur_c2w_pred: np.ndarray,
                         field_depth_fn=None):
        """Pseudo-depth of frame idx by triangulation at KNOWN poses (the
        estimate of the partner frame and the motion-model prediction
        cur_c2w_pred), without an essential-matrix solve: the partner is
        the reference keyframe (the previous tracked frame), or with the
        persistent map the newest cached keyframe at least 8 frames old
        (a longer baseline conditions the DLT better). The reprojection
        gate widens 3 -> 6 -> 10 px until 16 points pass; the scene-scale
        gate keeps depths within 0.25-4x the median gt depth, and with
        field_depth_fn (uv_px (N, 2) -> rendered field depth (N,)) a
        candidate of a 25 px gate within 15% of the field's depth is
        accepted too. Registers the pair in the map, makes frame idx the
        reference. Returns the pseudo-depth (H, W) or None."""
        if self.prev is None:
            return None
        feats_cur = self._feat_cache.pop(idx, None)
        if feats_cur is None:
            _, color_cur, _, _ = frame_reader[idx]
            feats_cur = self._extract(color_cur)
        ref_idx = self.prev["frame_idx"]
        kps_r, desc_r, val_r, ang_r = self.prev["feats"]
        kpn_ref_full = self._kpn(kps_r)
        if self.map is not None:
            older = [i for i in self._kf_order if idx - i >= 8]
            if older:
                kf = self._kfs[older[-1]]
                ref_idx = kf.frame_idx
                kpn_ref_full = self._dev(kf.kps)
                desc_r = self._dev(kf.desc)
                val_r = torch.as_tensor(np.asarray(kf.valid),
                                        device=self.device)
                ang_r = self._dev(kf.angles) \
                    if kf.angles is not None else None
        Tcw_ref_cv = nerf_c2w_to_cv_w2c(estimate_c2w_list[ref_idx])
        Tcw_cur_cv = nerf_c2w_to_cv_w2c(cur_c2w_pred)
        Tc, Tr = self._dev(Tcw_cur_cv), self._dev(Tcw_ref_cv)

        kps_c, desc_c, val_c, ang_c = feats_cur
        idx2, mvalid, _ = match_two_way(desc_c, val_c, desc_r, val_r,
                                        self.nn_thresh)
        if self.check_orientation and ang_r is not None:
            from .rotation_histogram import \
                filter_matches_with_histogram_orientation
            mvalid = filter_matches_with_histogram_orientation(
                ang_r[idx2], ang_c, mvalid, min_keep=16, min_frac=0.7)
        kpn_cur = self._kpn(kps_c)
        kpn_ref = kpn_ref_full[idx2]
        pts3d, ok = triangulate_points(Tc, Tr, kpn_cur, kpn_ref)
        for gate in (3.0, 6.0, 10.0):
            acc, z_cur, _, uvn_cur, uvn_ref = point_checks(
                pts3d, Tc, Tr, kpn_cur, kpn_ref, self.fx,
                max_reproj_px=gate)
            accept = _np(acc & mvalid & ok)
            if accept.sum() >= 16:
                break
        uv_cur = _np(uvn_cur) * [self.fx, self.fy] + [self.cx, self.cy]
        z_cur = _np(z_cur)
        n_cand = int(accept.sum())
        n_scale = n_field = -1
        if self.median_gt_depth is not None:
            scale_ok = (z_cur > 0.25 * self.median_gt_depth) \
                & (z_cur < 4.0 * self.median_gt_depth)
            if field_depth_fn is not None:
                acc_w, _, _, _, _ = point_checks(
                    pts3d, Tc, Tr, kpn_cur, kpn_ref, self.fx,
                    max_reproj_px=25.0)
                cand_wide = _np(acc_w & mvalid & ok)
                zf = _np(field_depth_fn(uv_cur))
                field_ok = (zf > 1e-3) & (z_cur > 1e-3) \
                    & (np.abs(z_cur - zf)
                       <= np.maximum(0.15 * zf,
                                     0.02 * self.median_gt_depth))
                n_field = int((cand_wide & field_ok).sum())
                accept = (accept & scale_ok) | (cand_wide & field_ok)
            else:
                accept = accept & scale_ok
            n_scale = int((accept & scale_ok).sum())
        self.telemetry.append({
            "idx": idx, "n_matches": int(_np(mvalid).sum()),
            "n_inliers": -1, "n_cand": n_cand, "n_scale_ok": n_scale,
            "n_field_ok": n_field, "n_accept": int(accept.sum()),
            "scale": float(self.depth_scale or 1.0)})
        uv_ref_px = _np(uvn_ref) * [self.fx, self.fy] + [self.cx, self.cy]
        self.last_debug = {"ref_idx": ref_idx, "cur_idx": idx,
                           "kps_ref": uv_ref_px, "kps_cur": uv_cur.copy(),
                           "accept": accept.copy()}
        self.prev = {"frame_idx": idx, "feats": feats_cur}
        if self.map is not None:
            # the map takes the pair's observations before the sparsity
            # exit: its confirmed projections can carry the frame alone
            kf_ref = self._kf_for(ref_idx, kpn_ref_full, desc_r, val_r,
                                  Tcw_ref_cv, angles=ang_r)
            kf_cur = self._kf_for(idx, kpn_cur, desc_c, val_c, Tcw_cur_cv,
                                  angles=ang_c)
            uv_m, z_m, acc_m = self._map_update(
                idx, kf_cur, kf_ref, _np(idx2), _np(pts3d), accept,
                Tcw_cur_cv)
            uv_cur = np.concatenate([uv_cur, uv_m], axis=0)
            z_cur = np.concatenate([z_cur, z_m], axis=0)
            accept = np.concatenate([accept, acc_m], axis=0)
        if int(accept.sum()) < 8:
            return None
        return self._splat(uv_cur, z_cur, accept)

    # -- checkpoint persistence ---------------------------------------------
    def state_arrays(self) -> dict:
        """The full front-end state as flat numpy arrays for a checkpoint,
        under the reference's keys: the reference keyframe and its
        features, the keyframe window (frame index, keypoints, descriptors,
        validity, Tcw, angles), the alive map points with their best
        descriptors and observations (as (point row, keyframe frame index,
        keypoint) triples), the counters, the parallax rate, the depth
        ratio, the matcher's threshold and the telemetry as JSON."""
        import json
        out = {}
        if self.prev is not None:
            kps, desc, val, ang = (None if a is None else _np(a)
                                   for a in self.prev["feats"])
            out["fe2_prev_idx"] = np.int64(self.prev["frame_idx"])
            out["fe2_prev_kps"] = np.asarray(kps, np.float32)
            out["fe2_prev_desc"] = np.asarray(desc, np.float32)
            out["fe2_prev_valid"] = np.asarray(val)
            if ang is not None:
                out["fe2_prev_ang"] = np.asarray(ang, np.float32)
        if self._kf_order:
            kfs = [self._kfs[i] for i in self._kf_order]
            out["fe2_kf_idx"] = np.asarray([kf.frame_idx for kf in kfs],
                                           np.int64)
            out["fe2_kf_kps"] = np.stack([kf.kps for kf in kfs]).astype(
                np.float32)
            out["fe2_kf_desc"] = np.stack([kf.desc for kf in kfs]).astype(
                np.float32)
            out["fe2_kf_valid"] = np.stack([kf.valid for kf in kfs])
            out["fe2_kf_Tcw"] = np.stack([kf.Tcw for kf in kfs]).astype(
                np.float64)
            if all(kf.angles is not None for kf in kfs):
                out["fe2_kf_ang"] = np.stack(
                    [kf.angles for kf in kfs]).astype(np.float32)
        if self.map is not None and self.map.points:
            alive = [mp for mp in self.map.points if not mp.is_bad]
            if alive:
                kfid2fidx = {self._kfs[i].id: i for i in self._kf_order}
                out["fe2_mp_pt"] = np.stack(
                    [mp.pt for mp in alive]).astype(np.float64)
                d0 = next((mp.des for mp in alive if mp.des is not None),
                          None)
                if d0 is not None:
                    des = np.zeros((len(alive), len(d0)), np.float32)
                    hasd = np.zeros((len(alive),), bool)
                    for i, mp in enumerate(alive):
                        if mp.des is not None:
                            des[i] = mp.des
                            hasd[i] = True
                    out["fe2_mp_des"] = des
                    out["fe2_mp_hasdes"] = hasd
                obs = [(i, kfid2fidx[kid], kp)
                       for i, mp in enumerate(alive)
                       for kid, kp in mp.observations.items()
                       if kid in kfid2fidx]
                out["fe2_obs"] = np.asarray(obs, np.int64).reshape(-1, 3)
        out["fe2_ref_fail"] = np.int64(self._ref_fail_count)
        out["fe2_reject_count"] = np.int64(self._reject_count)
        out["fe2_par_rate"] = np.float64(self._par_rate or 0.0)
        out["fe2_kp_depth_ratio0"] = np.float64(self.kp_depth_ratio0 or 0)
        if self.dyn is not None:
            out["fe2_dyn_thresh"] = np.float64(
                self.dyn.max_descriptor_distance)
        out["fe2_telemetry"] = np.str_(json.dumps(self.telemetry))
        return out

    def load_state_arrays(self, z) -> bool:
        """Restore what state_arrays saved; the reference keyframe's
        features go back to the device. Keyframes and map points are made
        anew in the saved order (new registry ids, as the reference's
        restore makes them). Returns False, changing nothing, when the
        checkpoint holds no `fe2_*` state (the caller then reseeds the
        reference keyframe)."""
        import json
        if "fe2_prev_idx" not in z:
            return False
        ang = z["fe2_prev_ang"] if "fe2_prev_ang" in z else None
        self.prev = {
            "frame_idx": int(z["fe2_prev_idx"]),
            "feats": (self._dev(z["fe2_prev_kps"]),
                      self._dev(z["fe2_prev_desc"]),
                      torch.as_tensor(np.asarray(z["fe2_prev_valid"]),
                                      device=self.device),
                      None if ang is None else self._dev(ang))}
        self._kfs, self._kf_order = {}, []
        if self.map is not None:
            self.map.points = []
        if "fe2_kf_idx" in z and self.map is not None:
            angs = z["fe2_kf_ang"] if "fe2_kf_ang" in z else None
            for s, fidx in enumerate(np.asarray(z["fe2_kf_idx"]).tolist()):
                kf = KeyFrame(int(fidx), np.asarray(z["fe2_kf_kps"][s]),
                              np.asarray(z["fe2_kf_desc"][s]),
                              np.asarray(z["fe2_kf_valid"][s]),
                              np.asarray(z["fe2_kf_Tcw"][s]),
                              angles=None if angs is None
                              else np.asarray(angs[s]))
                self._kfs[int(fidx)] = kf
                self._kf_order.append(int(fidx))
                self.map.add_keyframe(kf)
            if "fe2_mp_pt" in z:
                pts = np.asarray(z["fe2_mp_pt"])
                des = z["fe2_mp_des"] if "fe2_mp_des" in z else None
                hasd = z["fe2_mp_hasdes"] if "fe2_mp_hasdes" in z else None
                mps = [MapPoint(pts[i]) for i in range(len(pts))]
                obs = z["fe2_obs"] if "fe2_obs" in z \
                    else np.zeros((0, 3), np.int64)
                for row, fidx, kp in np.asarray(obs):
                    kf = self._kfs.get(int(fidx))
                    if kf is not None:
                        mps[int(row)].add_observation(kf, int(kp))
                for i, mp in enumerate(mps):
                    if des is not None and hasd is not None and hasd[i]:
                        mp.des = np.asarray(des[i])
                self.map.points = [mp for mp in mps
                                   if mp.num_observations >= 1]
                for fidx in self._kf_order:
                    self.map.graph.update_connections(self._kfs[fidx])
        self._ref_fail_count = int(z["fe2_ref_fail"]) \
            if "fe2_ref_fail" in z else 0
        self._reject_count = int(z["fe2_reject_count"]) \
            if "fe2_reject_count" in z else 0
        pr = float(z["fe2_par_rate"]) if "fe2_par_rate" in z else 0.0
        self._par_rate = pr if pr > 0 else None
        kpr = float(z["fe2_kp_depth_ratio0"]) \
            if "fe2_kp_depth_ratio0" in z else 0.0
        self.kp_depth_ratio0 = kpr if kpr > 0 else None
        if self.dyn is not None and "fe2_dyn_thresh" in z:
            self.dyn.max_descriptor_distance = float(z["fe2_dyn_thresh"])
        if "fe2_telemetry" in z:
            try:
                self.telemetry = json.loads(str(z["fe2_telemetry"]))
            except ValueError:
                pass
        return True
