"""Checkpoint logger and resume (the JAX reference's outputs/logger.py).

A checkpoint is <output>/ckpts/{idx:05d}.npz with the reference's keys and
layout, so either package resumes from the other's:
  idx, estimate_c2w_list, gt_c2w_list (n_img, 4, 4);
  keyframe_list (frame indices), kf_est_c2w, kf_gt_c2w (the keyframe
  store's whole (capacity, 7) camera tensors);
  the decoder as param_{i} in the reference's tree-flatten order
  (models.decoders.tree_order) and n_params; NICE's grids as grid_{i} in
  sorted name order (coarse, color, fine, middle) and n_grids;
  weak mode's pseudo-depths, sparse: pseudo_idx_{i} (frame), pseudo_nz_{i}
  (flat pixel indices > 0), pseudo_val_{i}, and n_pseudo;
  with the front-end: its scale anchors fe_median_gt_depth,
  fe_depth_scale, fe_step_hist, fe_ref_idx, fe_last_tracked_idx and its
  full state (frontend.SparseFrontend.state_arrays, the fe2_* keys);
  scale_telemetry as JSON.
Keyframe images are not stored: resume reloads them from the reader by
frame index.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..models.decoders import tree_order


def _cpu(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class Logger:
    def __init__(self, output: str, ckpt_freq: int, n_img: int,
                 no_log_on_first_frame: bool = True):
        self.output = output
        self.ckpt_freq = ckpt_freq
        self.n_img = n_img
        self.no_log_on_first_frame = no_log_on_first_frame
        os.makedirs(os.path.join(output, "ckpts"), exist_ok=True)

    def maybe_log(self, slam, idx: int):
        """Checkpoint frame idx at ckpt_freq (mapping frames only) and at
        the last frame."""
        want = ((idx % self.ckpt_freq == 0
                 and not (idx == 0 and self.no_log_on_first_frame))
                or idx == self.n_img - 1)
        if idx % slam.ecfg.every_frame != 0 and idx != self.n_img - 1:
            want = False
        if want:
            self.log(slam, idx)

    def log(self, slam, idx: int):
        kfs = slam.keyframes
        data = {"idx": idx,
                "estimate_c2w_list": slam.estimate_c2w_list,
                "gt_c2w_list": slam.gt_c2w_list,
                "keyframe_list": np.asarray(kfs.frame_idx, np.int64),
                "kf_est_c2w": _cpu(kfs.est_c2w),
                "kf_gt_c2w": _cpu(kfs.gt_c2w)}
        sd = slam.decoder.state_dict()
        names = tree_order(sd)
        for i, k in enumerate(names):
            data[f"param_{i}"] = _cpu(sd[k])
        data["n_params"] = len(names)
        if slam.nice:
            for i, name in enumerate(sorted(slam.c_grid)):
                data[f"grid_{i}"] = _cpu(slam.c_grid[name])
            data["n_grids"] = len(slam.c_grid)
        for i, (fidx, pd) in enumerate(sorted(slam.pseudo_depths.items())):
            pd = _cpu(pd)
            nz = np.flatnonzero(pd > 0)
            data[f"pseudo_idx_{i}"] = np.asarray([fidx], np.int64)
            data[f"pseudo_nz_{i}"] = nz.astype(np.int64)
            data[f"pseudo_val_{i}"] = pd.reshape(-1)[nz]
        data["n_pseudo"] = len(slam.pseudo_depths)
        fe = slam.frontend
        if fe is not None:
            # the metric-scale anchors: a resume without them would chain
            # the essential matrix's unit baseline as the camera's step
            data["fe_median_gt_depth"] = np.float64(fe.median_gt_depth or 0)
            data["fe_depth_scale"] = np.float64(fe.depth_scale or 0)
            data["fe_step_hist"] = np.asarray(fe._step_hist, np.float64)
            data["fe_ref_idx"] = np.int64(
                fe.prev["frame_idx"] if fe.prev is not None else -1)
            data["fe_last_tracked_idx"] = np.int64(
                fe._last_tracked_idx if fe._last_tracked_idx is not None
                else -1)
            data.update(fe.state_arrays())
        if slam.scale_telemetry:
            data["scale_telemetry"] = np.str_(
                json.dumps(slam.scale_telemetry))
        path = os.path.join(self.output, "ckpts", f"{idx:05d}.npz")
        np.savez_compressed(path, **data)
        if slam.verbose:
            print(f"Saved checkpoint {path}", flush=True)


def load_checkpoint(path: str, params_template: dict):
    """(state_dict, estimate_c2w_list, gt_c2w_list, keyframe_list, idx) of
    a checkpoint; the state_dict's tensors take the template's keys,
    devices and dtypes."""
    z = np.load(path)
    return (_params(z, params_template), z["estimate_c2w_list"],
            z["gt_c2w_list"], z["keyframe_list"], int(z["idx"]))


def _params(z, template: dict) -> dict:
    names = tree_order(template)
    if int(z["n_params"]) != len(names):
        raise ValueError(f"checkpoint holds {int(z['n_params'])} parameter "
                         f"arrays, the decoder {len(names)}")
    out = {}
    for i, k in enumerate(names):
        a = z[f"param_{i}"]
        if tuple(a.shape) != tuple(template[k].shape):
            raise ValueError(f"checkpoint param_{i} ({k}) has shape "
                             f"{a.shape}, the decoder "
                             f"{tuple(template[k].shape)}")
        out[k] = torch.as_tensor(a).to(device=template[k].device,
                                       dtype=template[k].dtype)
    return out


def resume_slam(slam, path: str) -> int:
    """Restore a fresh PointNeRFSLAM from a checkpoint, in the reference's
    order: decoder (and NICE's grids), poses, pseudo-depths (then bootstrapped), the
    front-end (its full state, else the reference keyframe reseeded),
    the scale anchors (from the data when the checkpoint lacks them, never
    1.0), the scale telemetry, the keyframes (images reloaded from the
    reader) and mapping_first_frame_done. Returns the next frame index."""
    z = np.load(path)
    with torch.no_grad():
        for k, v in _params(z, slam.decoder.state_dict()).items():
            slam.decoder.get_parameter(k).copy_(v)
    if slam.nice and "n_grids" in z:
        names = sorted(slam.c_grid)
        if int(z["n_grids"]) != len(names):
            raise ValueError(f"checkpoint holds {int(z['n_grids'])} grids, "
                             f"the system {len(names)}")
        for i, name in enumerate(names):
            g = slam.c_grid[name]
            if tuple(z[f"grid_{i}"].shape) != tuple(g.shape):
                raise ValueError(f"checkpoint grid_{i} ({name}) has shape "
                                 f"{z[f'grid_{i}'].shape}, the system "
                                 f"{tuple(g.shape)}")
            slam.c_grid[name] = torch.as_tensor(
                z[f"grid_{i}"], dtype=g.dtype, device=g.device)
    idx = int(z["idx"])
    n = min(len(z["estimate_c2w_list"]), slam.n_img)
    slam.estimate_c2w_list[:n] = z["estimate_c2w_list"][:n]
    slam.gt_c2w_list[:n] = z["gt_c2w_list"][:n]

    H, W = slam.H, slam.W
    n_pseudo = int(z["n_pseudo"]) if "n_pseudo" in z else 0
    for i in range(n_pseudo):
        fidx = int(z[f"pseudo_idx_{i}"][0])
        pd = np.zeros(H * W, np.float32)
        pd[z[f"pseudo_nz_{i}"]] = z[f"pseudo_val_{i}"]
        slam.pseudo_depths[fidx] = torch.as_tensor(pd.reshape(H, W),
                                                   device=slam.device)
    if slam.pseudo_depths:
        slam._bootstrapped = True
        if slam.frontend is not None:
            _restore_frontend(slam, z, idx)

    if "scale_telemetry" in z:
        try:
            slam.scale_telemetry = json.loads(str(z["scale_telemetry"]))
        except ValueError:
            pass

    for slot, fidx in enumerate(z["keyframe_list"].tolist()):
        _, color, depth, _ = slam.frame_reader[fidx]
        color_u8 = np.clip(np.asarray(color) * 255, 0, 255).astype(np.uint8)
        slam.keyframes.insert(
            fidx, color_u8, torch.as_tensor(np.asarray(depth, np.float32)),
            z["kf_est_c2w"][slot], pseudo_depth=slam.pseudo_depths.get(fidx),
            gt_c2w7=z["kf_gt_c2w"][slot])
    slam.mapping_first_frame_done = len(slam.keyframes) > 0
    return idx + 1


def _restore_frontend(slam, z, idx: int) -> None:
    fe = slam.frontend
    tef = slam.ecfg.track_every_frame
    if not fe.load_state_arrays(z):
        # a checkpoint without fe2_* state: reseed the reference keyframe
        # from its saved frame index, else the last tracked frame before
        # the resume point
        last = int(z["fe_ref_idx"]) if "fe_ref_idx" in z else -1
        if last < 0:
            last = max(tef, (idx // tef) * tef - tef)
        _, color, _, _ = slam.frame_reader[last]
        fe.prev = {"frame_idx": last, "feats": fe._extract(color)}
    lt = int(z["fe_last_tracked_idx"]) if "fe_last_tracked_idx" in z else -1
    fe._last_tracked_idx = lt if lt >= 0 else fe.prev["frame_idx"]
    # the metric-scale anchors; a checkpoint that lacks them gets them from
    # the data: the median tracked-frame step of the restored trajectory,
    # and the median of the restored pseudo-depth values
    mgd = float(z["fe_median_gt_depth"]) if "fe_median_gt_depth" in z \
        else 0.0
    dsc = float(z["fe_depth_scale"]) if "fe_depth_scale" in z else 0.0
    if dsc <= 0:
        tr = z["estimate_c2w_list"][:idx + 1:tef][-6:, :3, 3]
        if len(tr) >= 2:
            dsc = float(np.median(np.linalg.norm(np.diff(tr, axis=0),
                                                 axis=1)))
    if mgd <= 0:
        vals = np.concatenate([_cpu(pd).reshape(-1)
                               for pd in slam.pseudo_depths.values()])
        vals = vals[vals > 0.01]
        if len(vals):
            mgd = float(np.median(vals))
    if mgd > 0:
        fe.median_gt_depth = mgd
    if dsc > 0:
        fe.depth_scale = dsc
    if "fe_step_hist" in z:
        fe._step_hist = list(np.asarray(z["fe_step_hist"], np.float64))
