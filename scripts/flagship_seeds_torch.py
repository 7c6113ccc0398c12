#!/usr/bin/env python3
"""The flagship over front-end RANSAC seeds: how often its ATE meets the
bar.

  python scripts/flagship_seeds_torch.py [--config YAML] [--seeds 1 2]
      [--device cuda|cpu] [--max_frames N] [--summary FILE]
      [--ckpt_freq N] [--steps]
  python scripts/flagship_seeds_torch.py --tally SUMMARY [SUMMARY ...]
      [--earlier SEED=ATE ...]

For each seed, builds the port's PointNeRFSLAM on the config (default
configs/Synthetic/room_bench_weak.yaml, the 500-frame flagship) with the
checkpoint logger and mesher attached, as `python -m
pointnerf_slam_torch.run` does, replaces the front-end's RANSAC generator
(`slam.frontend.draws`, seeded 7 by default) with one seeded `s`, and runs
the sequence in-process and unchunked into output/flagship_seed{s}. Nothing
else differs from the default run: no gate, threshold or default is
touched. Per seed it prints the translation error of frames 15-35, the
frame-30 two-view solve from the front-end's telemetry (inliers,
candidates, parallax), the first frame whose solve the step gate
rejected, the wall seconds and the Horn-aligned ATE (tools/eval_ate.py:
RMSE, mean, median, max); it ends with k of n seeds meeting the bar and
the rate's 95% Clopper-Pearson interval, and with --summary it also writes
them as JSON. The 3D and 2D scoring of scripts/eval_room_bench_torch.sh is
left out. Prewarm the frame cache first
(scripts/prewarm_synth_cache_torch.py).

--ckpt_freq N sets the checkpoint logger's frequency in memory (the
YAML's mapping.ckpt_freq stays as it is; the logger checkpoints mapping
frames only, so 5 checkpoints every tracked frame of the flagship), each
run's checkpoints under output/flagship_seed{s}/ckpts/. --steps prints,
per tracked frame, the front-end's accepted step step_d (or the gate that
rejected the solve, with the step), the true step |gt[k] - gt[k - 5]| and
their ratio, the step-history gate's median (the median of the last 10
accepted steps, once there are 3), and the steps of the motion prior, the
two-view solve and the NeRF refine (scale telemetry) from the previous
tracked frame's refined centre, each against the true step; the summary
holds the series under "steps".

--tally counts the seeds of several summaries (runs made side by side,
one process each) and of --earlier SEED=ATE pairs (runs recorded
elsewhere) and prints k of n with the interval.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pointnerf_slam_torch.engine import PointNeRFSLAM  # noqa: E402
from pointnerf_slam_torch.engine.state import Draws  # noqa: E402
from pointnerf_slam_torch.io.config import load_config  # noqa: E402
from pointnerf_slam_torch.outputs import attach_outputs  # noqa: E402
from pointnerf_slam_torch.tools.eval_ate import evaluate_ate  # noqa: E402
from frame30_rate import interval  # noqa: E402  (scripts/, beside this one)

BAR_M = 0.10   # the flagship's ATE bar (PERF.md section 2)


def solve_at(telemetry, idx: int):
    """The two-view solve record of frame idx (None if it had none)."""
    for rec in telemetry:
        if rec.get("idx") == idx and "n_inliers" in rec:
            return {k: rec[k] for k in ("ref_idx", "n_inliers", "n_cand",
                                        "parallax", "par_eff", "n_accept")
                    if k in rec}
    return None


def first_step_rejection(telemetry):
    """The first frame the step gate rejected: the step-history gate
    (`rejected_step`) and the absolute step gate (`rejected_step_abs`)."""
    out = {}
    for key in ("rejected_step", "rejected_step_abs"):
        for rec in telemetry:
            if key in rec:
                out[key] = {"idx": rec["idx"], "step": rec[key],
                            "step_median": rec.get("step_median")}
                break
    return out


def step_series(fe_telemetry, scale_telemetry, gt_centers,
                track_every: int, hist_len: int = 10) -> list:
    """One record per tracked frame of the front-end's continuous solves:
    idx; step_d (the accepted step, None when a gate rejected the solve);
    rejected ("rejected_step" or "rejected_step_abs") with the rejected
    step; true_step |gt[idx] - gt[idx - track_every]| and step_d's ratio
    to it; gate_median, the median of the last hist_len accepted steps
    before idx (None below 3, where the gate does not act); and prior_step,
    solve_step and refined_step, the distances of the scale telemetry's
    c_prior, c_solve and c_refined from the previous tracked frame's
    c_refined, each with its ratio to true_step."""
    stel = {int(r["idx"]): r for r in scale_telemetry}
    hist, out = [], []
    for rec in fe_telemetry:
        if "ref_idx" not in rec and "rejected_step" not in rec \
                and "rejected_step_abs" not in rec:
            continue                     # the bootstrap's record
        idx = int(rec["idx"])
        if out and out[-1]["idx"] == idx:
            row = out[-1]                # a gate's record after the solve
        else:
            true = float(np.linalg.norm(
                np.asarray(gt_centers[idx])
                - np.asarray(gt_centers[idx - track_every])))
            row = {"idx": idx, "step_d": None, "rejected": None,
                   "true_step": true, "ratio": None,
                   "gate_median": float(np.median(hist))
                   if len(hist) >= 3 else None}
            st, prev = stel.get(idx, {}), stel.get(idx - track_every, {})
            for k in ("prior", "solve", "refined"):
                c, c0 = st.get(f"c_{k}"), prev.get("c_refined")
                d = None if c is None or c0 is None else float(
                    np.linalg.norm(np.asarray(c) - np.asarray(c0)))
                row[f"{k}_step"] = d
                row[f"{k}_ratio"] = None if d is None or true <= 0 \
                    else d / true
            out.append(row)
        for key in ("rejected_step", "rejected_step_abs"):
            if key in rec:
                row["rejected"] = key
                row["rejected_step"] = float(rec[key])
        if "step_d" in rec:
            row["step_d"] = float(rec["step_d"])
            if row["true_step"] > 0:
                row["ratio"] = row["step_d"] / row["true_step"]
            hist = (hist + [row["step_d"]])[-hist_len:]
    return out


def step_lines(seed: int, rows) -> list:
    """The --steps table of one seed, a line per tracked frame (mm)."""
    def mm(v):
        return "-" if v is None else f"{v * 1000:.2f}"

    def rt(v):
        return "-" if v is None else f"{v:.3f}"

    out = [f"seed {seed}: frame | step_d mm | true mm | ratio | gate "
           f"median mm | prior / solve / refined step mm (ratio)"]
    for r in rows:
        step = mm(r["step_d"]) if r["rejected"] is None else \
            f"REJECTED {r['rejected']} {mm(r['rejected_step'])}"
        out.append(
            f"seed {seed}: {r['idx']} | {step} | {mm(r['true_step'])} | "
            f"{rt(r['ratio'])} | {mm(r['gate_median'])} | "
            + " / ".join(f"{mm(r[k + '_step'])} ({rt(r[k + '_ratio'])})"
                         for k in ("prior", "solve", "refined")))
    return out


def rate_line(ates: dict) -> str:
    """k of n seeds meeting the bar, and the rate's interval."""
    k = sum(a <= BAR_M for a in ates.values())
    lo, hi = interval(k, len(ates))
    return (f"{k} of {len(ates)} seeds met ATE <= {BAR_M} m; 95% "
            f"Clopper-Pearson interval of the rate [{lo:.4f}, {hi:.4f}]")


def tally(paths, earlier) -> int:
    ates = {}
    for path in paths:
        with open(path) as fh:
            for r in json.load(fh)["seeds"]:
                ates[r["seed"]] = r["ate"]["rmse"]
    for item in earlier:
        seed, ate = item.split("=")
        ates[int(seed)] = float(ate)
    for s in sorted(ates):
        print(f"seed {s}: ATE RMSE {ates[s]:.6f} m", flush=True)
    print(rate_line(ates), flush=True)
    return 0


def seed_system(config: str, seed: int, device: str, max_frames,
                ckpt_freq=None):
    """The port's system on config with the outputs attached, its
    front-end's RANSAC generator seeded `seed`, writing into
    output/flagship_seed{seed}; ckpt_freq replaces the logger's frequency
    (the loaded config keeps the YAML's)."""
    cfg = load_config(config)
    out = os.path.join("output", f"flagship_seed{seed}")
    slam = PointNeRFSLAM(cfg, n_frames_cap=max_frames, device=device,
                         output=out)
    attach_outputs(slam)
    if ckpt_freq is not None:
        slam.logger.ckpt_freq = ckpt_freq
    slam.frontend.draws = Draws(
        torch.Generator(device=slam.device).manual_seed(seed))
    return slam, out


def run_seed(config: str, seed: int, device: str, max_frames,
             ckpt_freq=None) -> dict:
    slam, out = seed_system(config, seed, device, max_frames, ckpt_freq)
    t0 = time.time()
    est, gt = slam.run(0)
    if slam.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    ate = evaluate_ate(gt, est)
    terr = {int(r["idx"]): float(r["t_err_m"]) for r in slam.frame_log
            if "t_err_m" in r and 15 <= int(r["idx"]) <= 35}
    tel = slam.frontend.telemetry
    return {"seed": seed, "frames": int(slam.n_img), "wall_s": wall,
            "ate": {k.split(".")[-1]: v for k, v in ate.items()},
            "meets_bar": ate["absolute_translational_error.rmse"] <= BAR_M,
            "t_err_m": terr, "solve_30": solve_at(tel, 30),
            "first_step_rejection": first_step_rejection(tel),
            "steps": step_series(tel, slam.scale_telemetry,
                                 slam.gt_c2w_list[:, :3, 3],
                                 slam.ecfg.track_every_frame),
            "timings": dict(slam.timings), "output": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/Synthetic/"
                    "room_bench_weak.yaml")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--summary", default=None,
                    help="write the per-seed results here as JSON")
    ap.add_argument("--ckpt_freq", type=int, default=None,
                    help="the logger's checkpoint frequency (in memory)")
    ap.add_argument("--steps", action="store_true",
                    help="print the per-tracked-frame step series")
    ap.add_argument("--tally", nargs="+", default=None, metavar="SUMMARY",
                    help="count these summaries' seeds instead of running")
    ap.add_argument("--earlier", nargs="*", default=[], metavar="SEED=ATE",
                    help="with --tally: seeds run elsewhere, ATE in metres")
    args = ap.parse_args()
    if args.tally:
        return tally(args.tally, args.earlier)
    results = []
    for s in args.seeds:
        r = run_seed(args.config, s, args.device, args.max_frames,
                     args.ckpt_freq)
        a = r["ate"]
        print(f"seed {s}: {r['frames']} frames in {r['wall_s']:.1f} s; ATE "
              f"RMSE {a['rmse']:.6f} m (mean {a['mean']:.6f}, median "
              f"{a['median']:.6f}, max {a['max']:.6f}) over "
              f"{a['compared_pose_pairs']} pairs: "
              f"{'meets' if r['meets_bar'] else 'misses'} the {BAR_M} m bar",
              flush=True)
        print(f"seed {s}: t err (mm) " + ", ".join(
            f"{i} {v * 1000:.1f}" for i, v in sorted(r["t_err_m"].items())),
            flush=True)
        print(f"seed {s}: frame-30 solve {r['solve_30']}; first step-gate "
              f"rejection {r['first_step_rejection'] or 'none'}", flush=True)
        if args.steps:
            print("\n".join(step_lines(s, r["steps"])), flush=True)
        results.append(r)
    k = sum(r["meets_bar"] for r in results)
    lo, hi = interval(k, len(results))
    print(rate_line({r["seed"]: r["ate"]["rmse"] for r in results}),
          flush=True)
    if args.summary:
        os.makedirs(os.path.dirname(os.path.abspath(args.summary)),
                    exist_ok=True)
        with open(args.summary, "w") as fh:
            json.dump({"seeds": results, "k": k, "n": len(results),
                       "bar_m": BAR_M, "interval95": [lo, hi]}, fh,
                      indent=1, default=float)
    print(json.dumps({"seeds": [{"seed": r["seed"],
                                 "ate_rmse": r["ate"]["rmse"],
                                 "solve_30": r["solve_30"]}
                                for r in results],
                      "k": k, "n": len(results), "interval95": [lo, hi]},
                     default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
