"""Run the port's SLAM system on a config.

  python -m pointnerf_slam_torch.run <config> [--max_frames N]
      [--device cuda|cpu] [--output DIR] [--resume CKPT]
      [--max_restarts R [--frames_per_attempt M] [--no_eval]]

Runs sensor-depth and weak-depth (RGB-only) configs. Prints, per processed
frame, the tracking loss (first -> best), the camera error against gt
(mean |cam7 - gt cam7| and translation error in metres), the host
seconds of the front-end, tracking and mapping (on the card also each
phase's time between its events on the stream), and the mapping loss
(first -> last); at the end the translation RMSE and max of the poses
against gt, unaligned and Horn-aligned (tools/eval_ate.py), and one line
of phase seconds, which is also appended to <output>/run_log.txt. Output
(--output, else the config's data.output): checkpoints in <output>/ckpts/
(mapping.ckpt_freq, the last frame, and before each mapping frame the
state up to the frame before it), meshes in <output>/mesh/ (one every
mapping.mesh_freq frames; at the last frame `final_mesh.ply` and, with
meshing.eval_rec, `final_mesh_eval_rec.ply`).

--resume CKPT continues a run from a checkpoint (outputs/logger.py).
--max_restarts R supervises: the run is executed again as a subprocess
from the latest checkpoint in <output>/ckpts/ after a failure, up to R
times; with --frames_per_attempt M each attempt stops after M frames (and
then skips the end-of-sequence colour refine and final meshes) and the
next resumes. A supervised run that completes a synthetic sequence is
scored by scripts/eval_room_bench_torch.sh (the port's tools; no JAX)
into <output>/eval_metrics.txt unless --no_eval; a failed evaluation
makes the supervisor return non-zero.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .engine import PointNeRFSLAM
from .io.config import load_config
from .outputs import attach_outputs
from .tools.eval_ate import evaluate_ate, latest_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def trajectory_errors(est: np.ndarray, gt: np.ndarray) -> dict:
    """Translation error of (N, 4, 4) estimated poses against gt in metres:
    RMSE and max unaligned, and after Horn alignment (tools/eval_ate.py's
    ATE, computed as that tool computes it from a checkpoint of the
    same poses)."""
    e, g = est[:, :3, 3].astype(np.float64), gt[:, :3, 3].astype(np.float64)
    raw = np.linalg.norm(e - g, axis=1)
    ate = evaluate_ate(gt, est)
    return {"rmse": float(np.sqrt(np.mean(raw ** 2))), "max": float(raw.max()),
            "ate_rmse": ate["absolute_translational_error.rmse"],
            "ate_max": ate["absolute_translational_error.max"]}


def checkpoint_index(path) -> int:
    return int(os.path.basename(path).split(".")[0]) if path else -1


def supervise(args) -> int:
    """Run the sequence as subprocesses of this module, each resuming from
    the latest checkpoint; again after a failure, up to args.max_restarts
    times. Returns 0 when the sequence completed (and, unless --no_eval,
    its evaluation passed)."""
    cfg = load_config(args.config)
    out = args.output or cfg["data"]["output"]
    from .io.datasets import get_dataset
    total = len(get_dataset(cfg))
    if args.max_frames:
        total = min(total, args.max_frames)
    base = [sys.executable, "-m", "pointnerf_slam_torch.run", args.config,
            "--device", args.device, "--output", out]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    chunk = args.frames_per_attempt
    # a supervisor started again continues from the run's own checkpoints
    resume = args.resume or latest_checkpoint(out)
    for attempt in range(args.max_restarts + 1):
        start = checkpoint_index(resume) + 1 if resume else 0
        cap = min(start + chunk, total) if chunk > 0 else total
        cmd = base + ["--max_frames", str(cap)]
        if cap < total:
            cmd.append("--no_final_refine")   # not the sequence's end
        if resume:
            cmd += ["--resume", resume]
        print(f"[supervisor] attempt {attempt}: {' '.join(cmd[2:])}",
              flush=True)
        rc = subprocess.run(cmd, env=env).returncode
        resume = latest_checkpoint(out)
        done = checkpoint_index(resume)
        if rc == 0 and done >= total - 1:
            print(f"[supervisor] finished at frame {done}", flush=True)
            if args.no_eval:
                return 0
            return evaluate_completed_run(out, cfg)
        if rc != 0:
            print(f"[supervisor] attempt failed (rc={rc}); latest "
                  f"checkpoint {resume}", flush=True)
    print("[supervisor] restart budget exhausted", flush=True)
    return 1


def evaluate_completed_run(out: str, cfg) -> int:
    """Score a completed synthetic run with scripts/eval_room_bench_torch.sh
    (ATE, 3D accuracy / completion, 2D depth-L1 with and without the view
    rejection) in a subprocess; returns its exit code."""
    if cfg["data"].get("dataset") != "synthetic":
        return 0   # no ground-truth mesh for a real dataset
    script = os.path.join(REPO, "scripts", "eval_room_bench_torch.sh")
    print(f"[supervisor] evaluating completed run: {out}", flush=True)
    env = dict(os.environ, PYTHON=sys.executable)
    rc = subprocess.run(["bash", script, os.path.abspath(out)],
                        env=env).returncode
    if rc == 0:
        print(f"[supervisor] eval done -> {out}/eval_metrics.txt",
              flush=True)
    else:
        print(f"[supervisor] EVAL FAILED (rc={rc})", flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--max_frames", type=int, default=None,
                    help="process frames 0 .. N-1 of the sequence")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--output", type=str, default=None,
                    help="output folder, overrides the config's")
    ap.add_argument("--resume", type=str, default=None,
                    help="checkpoint (.npz) to continue from")
    ap.add_argument("--max_restarts", type=int, default=0,
                    help="supervise: run again from the latest checkpoint "
                         "after a failure, up to N times")
    ap.add_argument("--frames_per_attempt", type=int, default=0,
                    help="with --max_restarts: each attempt processes at "
                         "most N frames, the next resumes")
    ap.add_argument("--no_eval", action="store_true",
                    help="with --max_restarts: do not score the completed "
                         "run")
    ap.add_argument("--no_final_refine", action="store_true",
                    help=argparse.SUPPRESS)   # a chunked attempt's end
    args = ap.parse_args(argv)
    if args.max_restarts > 0:
        return supervise(args)
    cfg = load_config(args.config)
    if args.no_final_refine:
        cfg["mapping"]["color_refine"] = False
        cfg["meshing"]["eval_rec"] = False
        cfg["meshing"]["final_mesh"] = False
    slam = PointNeRFSLAM(cfg, n_frames_cap=args.max_frames,
                         device=args.device, output=args.output)
    attach_outputs(slam)
    start = 0
    if args.resume:
        from .outputs.logger import resume_slam
        start = resume_slam(slam, args.resume)
        print(f"resumed from {args.resume}; continuing at frame {start}",
              flush=True)
    t0 = time.time()

    def on_frame(s, idx):
        if s.frame_log and s.frame_log[-1]["idx"] == idx:
            print(frame_line(s.frame_log[-1]), flush=True)

    est, gt = slam.run(start, on_frame=on_frame)
    if slam.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    err = trajectory_errors(est, gt)
    print(f"done: frames {start}..{slam.n_img - 1} in {wall:.1f} s "
          f"on {slam.device}; translation RMSE against gt over frames "
          f"0..{slam.n_img - 1} (unaligned) {err['rmse']:.4f} m, max "
          f"{err['max']:.4f} m; Horn-aligned (ATE) RMSE "
          f"{err['ate_rmse']:.4f} m, max {err['ate_max']:.4f} m; "
          f"checkpoints in {os.path.join(slam.output, 'ckpts')}, meshes in "
          f"{os.path.join(slam.output, 'mesh')}", flush=True)
    line = phase_line(slam, start, wall)
    print(line, flush=True)
    with open(os.path.join(slam.output, "run_log.txt"), "a") as fh:
        fh.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')} {line}\n")
    return 0


def phase_line(slam, start: int, wall: float) -> str:
    """Frames, wall seconds, and the host (and on the card, device)
    seconds of the front-end, tracking and mapping of this attempt."""
    t = slam.timings
    dev = {}
    for rec in slam.frame_log:
        for k, v in PointNeRFSLAM.device_seconds(rec).items():
            dev[k] = dev.get(k, 0.0) + v
    parts = [f"{k} {t[k]:.1f} s" + (f" (card {dev[k]:.1f} s)" if k in dev
                                    else "")
             for k in ("frontend", "tracking", "mapping")]
    n = slam.n_img - start
    return (f"frames {start}..{slam.n_img - 1} ({n}) in {wall:.1f} s wall "
            f"({n / max(wall, 1e-9):.3f} frames/s): " + ", ".join(parts))


if __name__ == "__main__":
    raise SystemExit(main())
