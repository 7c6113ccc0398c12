"""Run the port's SLAM system on a config.

  python -m pointnerf_slam_torch.run <config> [--max_frames N]
                                     [--device cuda|cpu] [--output DIR]

Runs sensor-depth and weak-depth (RGB-only) configs. Prints, per processed
frame, the tracking loss (first -> best), the camera error against gt
(mean |cam7 - gt cam7| and translation error in metres), the host
seconds of the front-end, tracking and mapping (on the card also each
phase's time between its events on the stream), and the mapping loss
(first -> last); at the end the translation RMSE and max of all
estimated poses against gt, unaligned and Horn-aligned (the ATE of the
JAX reference's tools/eval_ate.py). Meshes go to <output>/mesh/ (output:
--output, else the config's data.output): one every mapping.mesh_freq
frames, and at the last frame `final_mesh.ply` and, with
meshing.eval_rec, `final_mesh_eval_rec.ply`, in the reference's PLY
format (the JAX reference's tools/eval_recon.py scores them).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .engine import PointNeRFSLAM
from .io.config import load_config
from .outputs import attach_outputs


def frame_line(rec: dict) -> str:
    parts = [f"frame {rec['idx']:4d}"]
    if "track_first" in rec:
        parts.append(f"track {float(rec['track_first']):.2f} -> "
                     f"{float(rec['track_best']):.2f}")
        parts.append(f"cam err {float(rec['cam_err']):.5f} "
                     f"(t {float(rec['t_err_m']) * 1000:.1f} mm)")
    dev = PointNeRFSLAM.device_seconds(rec)
    secs = [f"{k} {rec[k + '_s']:.2f} s" + (f" (card {dev[k]:.2f} s)"
                                            if k in dev else "")
            for k in ("frontend", "tracking", "mapping") if k + "_s" in rec]
    if secs:
        parts.append(", ".join(secs))
    if "map_losses" in rec:
        ls = rec["map_losses"]
        parts.append(f"map {float(ls[0]):.1f} -> {float(ls[-1]):.1f} "
                     f"({ls.numel()} it)")
    return "  ".join(parts)


def align_horn(model: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Per-pose translation error after the rigid alignment data ~= R @
    model + t (both (3, N)), Horn's closed form by SVD (the JAX
    reference's tools/eval_ate.py)."""
    mz = model - model.mean(axis=1, keepdims=True)
    dz = data - data.mean(axis=1, keepdims=True)
    U, _, Vt = np.linalg.svd((mz @ dz.T).T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vt
    trans = data.mean(axis=1, keepdims=True) - rot @ model.mean(
        axis=1, keepdims=True)
    return np.sqrt(np.sum((rot @ model + trans - data) ** 2, axis=0))


def trajectory_errors(est: np.ndarray, gt: np.ndarray) -> dict:
    """Translation error of (N, 4, 4) estimated poses against gt in metres:
    RMSE and max unaligned, and after Horn alignment (the reference's ATE)."""
    e, g = est[:, :3, 3].astype(np.float64), gt[:, :3, 3].astype(np.float64)
    raw = np.linalg.norm(e - g, axis=1)
    ali = align_horn(e.T, g.T)
    return {"rmse": float(np.sqrt(np.mean(raw ** 2))), "max": float(raw.max()),
            "ate_rmse": float(np.sqrt(np.mean(ali ** 2))),
            "ate_max": float(ali.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--output", type=str, default=None,
                    help="output folder, overrides the config's")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    slam = PointNeRFSLAM(cfg, n_frames_cap=args.max_frames,
                         device=args.device, output=args.output)
    attach_outputs(slam)
    t0 = time.time()

    def on_frame(s, idx):
        if s.frame_log and s.frame_log[-1]["idx"] == idx:
            print(frame_line(s.frame_log[-1]), flush=True)

    est, gt = slam.run(on_frame=on_frame)
    if slam.device.type == "cuda":
        torch.cuda.synchronize()
    err = trajectory_errors(est, gt)
    print(f"done: {slam.n_img} frames in {time.time() - t0:.1f} s "
          f"on {slam.device}; translation RMSE against gt over all frames "
          f"(unaligned) {err['rmse']:.4f} m, max {err['max']:.4f} m; "
          f"Horn-aligned (ATE) RMSE {err['ate_rmse']:.4f} m, max "
          f"{err['ate_max']:.4f} m; meshes in "
          f"{os.path.join(slam.output, 'mesh')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
