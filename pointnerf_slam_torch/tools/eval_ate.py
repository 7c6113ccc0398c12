"""ATE of a run (the JAX reference's tools/eval_ate.py; numpy only).

Horn's closed-form rigid alignment of the estimated to the ground-truth
trajectory, then translation RMSE / mean / median / std / min / max. The
command line reads one of the port's checkpoints (translations divided by
--scale; gt rows with inf or nan, and never-filled all-zero rows, are
dropped):

  python -m pointnerf_slam_torch.tools.eval_ate <ckpt.npz | output dir>
      [--scale S] [--plot traj.png]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def align_horn(model: np.ndarray, data: np.ndarray):
    """Rigid alignment data ~= rot @ model + trans (both (3, N)): returns
    rot (3, 3), trans (3, 1) and the per-pose translation error (N,)."""
    model_mean = model.mean(axis=1, keepdims=True)
    data_mean = data.mean(axis=1, keepdims=True)
    W = (model - model_mean) @ (data - data_mean).T
    U, _, Vt = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vt
    trans = data_mean - rot @ model_mean
    err = np.sqrt(np.sum((rot @ model + trans - data) ** 2, axis=0))
    return rot, trans, err


def evaluate_ate(gt_c2w: np.ndarray, est_c2w: np.ndarray,
                 scale: float = 1.0) -> dict:
    """ATE statistics over (N, 4, 4) pose arrays."""
    gt_t = gt_c2w[:, :3, 3] / scale
    est_t = est_c2w[:, :3, 3] / scale
    ok = np.isfinite(gt_t).all(axis=1) & np.isfinite(est_t).all(axis=1)
    ok &= ~(np.abs(gt_c2w).sum(axis=(1, 2)) == 0)
    _, _, err = align_horn(est_t[ok].T, gt_t[ok].T)
    return {
        "compared_pose_pairs": int(ok.sum()),
        "absolute_translational_error.rmse": float(
            np.sqrt(np.mean(err ** 2))),
        "absolute_translational_error.mean": float(err.mean()),
        "absolute_translational_error.median": float(np.median(err)),
        "absolute_translational_error.std": float(err.std()),
        "absolute_translational_error.min": float(err.min()),
        "absolute_translational_error.max": float(err.max()),
    }


def plot_traj(gt_c2w, est_c2w, out_png: str, scale: float = 1.0):
    """Top-down (x, y) plot of both trajectories."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    gt = gt_c2w[:, :3, 3] / scale
    est = est_c2w[:, :3, 3] / scale
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(gt[:, 0], gt[:, 1], "-", color="black", label="ground truth")
    ax.plot(est[:, 0], est[:, 1], "-", color="blue", label="estimated")
    ax.legend()
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_aspect("equal")
    fig.savefig(out_png, dpi=110, bbox_inches="tight")
    plt.close(fig)


def latest_checkpoint(path: str):
    """path itself if it is a file, else the newest .npz under path/ckpts
    (or under path); None if there is none."""
    if os.path.isfile(path):
        return path
    cdir = os.path.join(path, "ckpts")
    cdir = cdir if os.path.isdir(cdir) else path
    cands = sorted(f for f in os.listdir(cdir) if f.endswith(".npz")) \
        if os.path.isdir(cdir) else []
    return os.path.join(cdir, cands[-1]) if cands else None


def main(argv=None):
    p = argparse.ArgumentParser(description="ATE from a checkpoint")
    p.add_argument("ckpt", help="a ckpts/XXXXX.npz, or an output directory "
                   "(its latest checkpoint)")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--plot", default=None, help="save a trajectory png here")
    args = p.parse_args(argv)
    path = latest_checkpoint(args.ckpt)
    if path is None:
        raise SystemExit(f"no .npz checkpoint at {args.ckpt}")
    if path != args.ckpt:
        print(f"using {path}")
    z = np.load(path)
    stats = evaluate_ate(z["gt_c2w_list"], z["estimate_c2w_list"],
                         args.scale)
    for k, v in stats.items():
        print(f"{k} {v:.6f}" if isinstance(v, float) else f"{k} {v}")
    if args.plot:
        plot_traj(z["gt_c2w_list"], z["estimate_c2w_list"], args.plot,
                  args.scale)
        print(f"saved {args.plot}")


if __name__ == "__main__":
    main()
