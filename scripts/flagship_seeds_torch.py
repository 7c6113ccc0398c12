#!/usr/bin/env python3
"""The flagship over front-end RANSAC seeds: how often its ATE meets the
bar.

  python scripts/flagship_seeds_torch.py [--config YAML] [--seeds 1 2]
      [--device cuda|cpu] [--max_frames N] [--summary FILE]
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


def run_seed(config: str, seed: int, device: str, max_frames) -> dict:
    cfg = load_config(config)
    out = os.path.join("output", f"flagship_seed{seed}")
    slam = PointNeRFSLAM(cfg, n_frames_cap=max_frames, device=device,
                         output=out)
    attach_outputs(slam)
    slam.frontend.draws = Draws(
        torch.Generator(device=slam.device).manual_seed(seed))
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
    ap.add_argument("--tally", nargs="+", default=None, metavar="SUMMARY",
                    help="count these summaries' seeds instead of running")
    ap.add_argument("--earlier", nargs="*", default=[], metavar="SEED=ATE",
                    help="with --tally: seeds run elsewhere, ATE in metres")
    args = ap.parse_args()
    if args.tally:
        return tally(args.tally, args.earlier)
    results = []
    for s in args.seeds:
        r = run_seed(args.config, s, args.device, args.max_frames)
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
