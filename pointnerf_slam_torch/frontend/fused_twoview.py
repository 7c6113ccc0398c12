"""The two-view front-end step (the JAX reference's frontend/fused_twoview.py):
descriptor matching, orientation gate, E-matrix RANSAC, triangulation,
acceptance checks, baseline scale, field-consistency gate and LM pose
refinement, on the device, returning two packed tensors that the host
reads in two transfers.

The reference compiles the chain into one XLA program per variant to
save dispatches; here it is a plain function of torch ops on the system's
device. Variants (`mode`):
  'bootstrap'   scale = median_gt_depth / median triangulated depth
  'continuous'  scale carried in (depth_scale); scale-window gate
  'field'       continuous + a field-anchored scale and a consistency gate
                from the current field's depth rendered at the
                reprojection pixels under the predicted pose. The reference
                renders it with its XLA renderer (no Pallas kernel), so the
                port renders it with the plain torch renderer on the device.
The RANSAC hypotheses come from `draws` (engine/state.Draws): a torch
generator, or the reference's draws replayed by the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.rays import rays_from_uv
from ..core.se3 import camera_from_tensor, tensor_from_camera, \
    to_homogeneous
from ..render.renderer import render_rays
from ..utils import tracing
from .ba import pose_optimization
from .epipolar import draw_hypotheses, estimate_relative_pose_ransac
from .matching import match_two_way
from .rotation_histogram import filter_matches_with_histogram_orientation
from .triangulate import point_checks, triangulate_points


def masked_median(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The lower median of x[m] (0 if empty), from one sort."""
    xs = torch.sort(torch.where(m, x, torch.full_like(x, 3e38)))[0]
    n = m.sum()
    idx = torch.div(n - 1, 2, rounding_mode="floor").clamp(0, x.shape[0] - 1)
    with tracing.wait("masked_median"):
        return torch.where(n > 0, xs[idx], torch.zeros_like(xs[0]))


def _center(T: torch.Tensor) -> torch.Tensor:
    return -T[:3, :3].T @ T[:3, 3]


def make_two_view_step(H, W, fx, fy, cx, cy, ransac_thresh, mode: str,
                       rcfg=None, bundle_loss: bool = True,
                       check_orientation: bool = True):
    """step(feats_ref, feats_cur, Tcw_ref (4, 4), draws, median_gt_depth,
    depth_scale, nn_thresh, decoder, c2w_pred, bound) -> (out_kp (K, 13),
    out_small (28,)):
      out_kp columns: u_cur, v_cur, u_ref, v_ref, z_cur, z_ref, accept,
                      field_ok, px, py, pz, idx2, cand (z scaled, p world)
      out_small: Tcw_cur (16), n_matches, n_inliers, n_cand, n_scale_ok,
                 n_field_ok, n_accept, scale, scale_raw, score_med,
                 score_mad, parallax_med_deg, 0
    decoder / c2w_pred / bound are read in 'field' mode only."""
    assert mode in ("bootstrap", "continuous", "field"), mode
    if mode == "field":
        assert rcfg is not None

    def step(feats_ref, feats_cur, Tcw_ref, draws, median_gt_depth,
             depth_scale, nn_thresh, decoder=None, c2w_pred=None,
             bound=None):
        kps_r, desc_r, val_r, ang_r = feats_ref
        kps_c, desc_c, val_c, ang_c = feats_cur
        dev = kps_c.device
        K = kps_c.shape[0]
        with tracing.wait("two_view_consts"):
            f = torch.tensor([fx, fy], dtype=torch.float32, device=dev)
        with tracing.wait("two_view_consts"):
            c = torch.tensor([cx, cy], dtype=torch.float32, device=dev)

        idx2, mvalid, scores = match_two_way(desc_c, val_c, desc_r, val_r,
                                             nn_thresh)
        if check_orientation:
            mvalid = filter_matches_with_histogram_orientation(
                ang_r[idx2], ang_c, mvalid, min_keep=16, min_frac=0.7)
        s_med = masked_median(scores, mvalid)
        s_mad = 1.4826 * masked_median((scores - s_med).abs(), mvalid)
        kpn_cur = (kps_c - c) / f
        kpn_ref = ((kps_r - c) / f)[idx2]

        hyp = draws.take(lambda g: draw_hypotheses(g, mvalid))
        Trc, inliers, n_inl = estimate_relative_pose_ransac(
            kpn_ref, kpn_cur, mvalid, hyp.to(dev), thresh=ransac_thresh)
        R, t = Trc[:3, :3], Trc[:3, 3]
        Tcr = torch.eye(4, device=dev)
        Tcr[:3, :3] = R.T
        Tcr[:3, 3] = -R.T @ t
        Tcw_cur = Tcr @ Tcw_ref                     # unit baseline

        pts3d, ok = triangulate_points(Tcw_cur, Tcw_ref, kpn_cur, kpn_ref)
        accept, z_cur, z_ref, uvn_cur, uvn_ref = point_checks(
            pts3d, Tcw_cur, Tcw_ref, kpn_cur, kpn_ref, fx)
        accept = accept & inliers & ok
        cand_mask = accept
        n_cand = accept.sum()

        # median triangulation parallax over the candidates (deg)
        v1 = pts3d - _center(Tcw_ref)[None]
        v2 = pts3d - _center(Tcw_cur)[None]
        cosp = (v1 * v2).sum(-1) / torch.clamp(
            torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1),
            min=1e-12)
        par_deg = torch.rad2deg(torch.arccos(cosp.clamp(-1.0, 1.0)))
        par_med = masked_median(par_deg, accept)

        uv_cur = uvn_cur * f + c
        uv_ref = uvn_ref * f + c

        zf = torch.zeros(K, device=dev)
        if mode == "field":
            ro, rd = rays_from_uv(uv_cur[:, 0], uv_cur[:, 1],
                                  c2w_pred, fx, fy, cx, cy)
            with torch.no_grad():
                zf = render_rays(decoder, rcfg, ro, rd, bound, None)[0]
        with tracing.wait("two_view_consts"):
            mg = torch.as_tensor(median_gt_depth, dtype=torch.float32,
                                 device=dev)
        with tracing.wait("two_view_consts"):
            ds = torch.as_tensor(depth_scale, dtype=torch.float32,
                                 device=dev)
        s_raw = None
        if mode == "bootstrap":
            s = mg / torch.clamp(masked_median(z_cur, accept), min=1e-9)
        elif mode == "field":
            okf = accept & (zf > 1e-3) & (z_cur > 1e-6)
            s_field = masked_median(zf, okf) / torch.clamp(
                masked_median(z_cur, okf), min=1e-9)
            use = (okf.sum() >= 4) & torch.isfinite(s_field) & (s_field > 0)
            s_field = torch.minimum(torch.maximum(s_field, 0.25 * ds),
                                    4.0 * ds)
            s_raw = torch.where(use, s_field, ds)
            s = torch.where(use, 0.4 * s_field + 0.6 * ds, ds)
        else:
            s = ds

        # scale baseline and structure about the reference camera centre
        C_ref, C_cur = _center(Tcw_ref), _center(Tcw_cur)
        C_cur_s = C_ref + s * (C_cur - C_ref)
        Tcw_cur = Tcw_cur.clone()
        Tcw_cur[:3, 3] = -Tcw_cur[:3, :3] @ C_cur_s
        pts_s = C_ref + s * (pts3d - C_ref)
        z_cur_s, z_ref_s = s * z_cur, s * z_ref

        if bundle_loss:
            cam, _, n_in = pose_optimization(
                tensor_from_camera(Tcw_cur), pts_s, kpn_cur, accept,
                sigma2=(1.0 / fx) ** 2)
            T_lm = to_homogeneous(camera_from_tensor(cam))
            Tcw_cur = torch.where(n_in >= 8, T_lm, Tcw_cur)

        with tracing.wait("two_view_consts"):
            minus1 = torch.tensor(-1, device=dev)
        n_scale_ok = n_field_ok = minus1
        field_ok = torch.zeros(K, dtype=torch.bool, device=dev)
        if mode != "bootstrap":
            scale_ok = (z_cur_s > 0.25 * mg) & (z_cur_s < 4.0 * mg)
            if mode == "field":
                field_ok = (zf > 1e-3) & (z_cur_s > 1e-3) \
                    & ((z_cur_s - zf).abs()
                       <= torch.maximum(0.15 * zf, 0.02 * mg))
                n_field_ok = (accept & field_ok).sum()
                accept = accept & (scale_ok | field_ok)
            else:
                accept = accept & scale_ok
            n_scale_ok = (accept & scale_ok).sum()

        fl = lambda x: x.to(torch.float32)
        out_kp = torch.cat([
            uv_cur, uv_ref, z_cur_s[:, None], z_ref_s[:, None],
            fl(accept)[:, None], fl(field_ok)[:, None], pts_s,
            fl(idx2)[:, None], fl(cand_mask)[:, None]], dim=1)
        counts = torch.stack([mvalid.sum(), n_inl, n_cand, n_scale_ok,
                              n_field_ok, accept.sum()])
        out_small = torch.cat([
            Tcw_cur.reshape(-1), fl(counts),
            torch.stack([s, s if s_raw is None else s_raw]),
            torch.stack([s_med, s_mad]),
            torch.stack([par_med, torch.zeros_like(par_med)])])
        return out_kp, out_small

    return step


class TwoViewRunner:
    """The per-mode steps and the host unpacking of their results."""

    def __init__(self, H, W, fx, fy, cx, cy, nn_thresh, ransac_thresh,
                 rcfg=None, bundle_loss=True, check_orientation=True):
        self._mk = lambda mode: make_two_view_step(
            H, W, fx, fy, cx, cy, ransac_thresh, mode, rcfg=rcfg,
            bundle_loss=bundle_loss, check_orientation=check_orientation)
        self._nn_default = float(nn_thresh)
        self._steps = {}

    def run(self, mode, feats_ref, feats_cur, Tcw_ref, draws,
            median_gt_depth, depth_scale, nn_thresh=None, decoder=None,
            c2w_pred=None, bound=None):
        if mode not in self._steps:
            self._steps[mode] = self._mk(mode)
        dev = feats_cur[0].device

        def as_dev(a):
            with tracing.wait("two_view_upload"):
                return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                       device=dev)
        out_kp, out_small = self._steps[mode](
            feats_ref, feats_cur, as_dev(Tcw_ref), draws,
            float(median_gt_depth or 1.0), float(depth_scale or 1.0),
            self._nn_default if nn_thresh is None else float(nn_thresh),
            decoder, None if c2w_pred is None else as_dev(c2w_pred), bound)
        with tracing.wait("two_view_read"):
            kp = out_kp.cpu().numpy()
        with tracing.wait("two_view_read"):
            small = out_small.cpu().numpy()
        return {
            "Tcw_cur": small[:16].reshape(4, 4).astype(np.float64),
            "uv_cur": kp[:, 0:2], "uv_ref": kp[:, 2:4],
            "z_cur": kp[:, 4], "z_ref": kp[:, 5],
            "accept": kp[:, 6] > 0.5, "field_ok": kp[:, 7] > 0.5,
            "pts3d": kp[:, 8:11].astype(np.float64),
            "idx2": kp[:, 11].astype(np.int64),
            "cand": kp[:, 12] > 0.5,
            "n_matches": int(small[16]), "n_inliers": int(small[17]),
            "n_cand": int(small[18]), "n_scale_ok": int(small[19]),
            "n_field_ok": int(small[20]), "n_accept": int(small[21]),
            "scale": float(small[22]), "scale_raw": float(small[23]),
            "score_med": float(small[24]), "score_mad": float(small[25]),
            "parallax": float(small[26]),
        }
