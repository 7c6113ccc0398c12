#!/usr/bin/env python3
"""Frame-by-frame tracking of the two packages on the same frames, on the
CPU.

  python scripts/track_compare.py [--config configs/Synthetic/room_bench.yaml]
      [--frames 6] [--pixels 1000] [--iters_first 300] [--out result.json]
      [--fe_seed 7] [--only jax|torch] [--device cpu|cuda]
      [--input_folder DIR --bound JSON] [--frame_cache DIR] [--cpu_draws]

Runs frames 0..N-1 of a synthetic config at full resolution and full
decoder width through the JAX reference and through the PyTorch port,
each in its own subprocess (this script imports neither). Both take the
same cut budgets: rendering.megakernel off (the plain renderer in both,
so neither runs a kernel), tracking and mapping pixels --pixels,
mapping.iters_first --iters_first, the flagship schedule (fused_outer,
resample_every 4 / 5) and no colour refine, as chip_smoke's system
phases run it. Prints, per tracked frame and package, the tracking loss
(first -> best) and the translation error against gt in mm, and the
per-frame difference of the two packages' errors. For a weak-depth
config it also prints, per tracked frame, the front-end's solve (matches,
inliers, candidates, parallax and its gated value, scale) and the errors
of the motion prior, the solve and the NeRF refine against gt (the
scale telemetry). The packages draw their pixels and RANSAC hypotheses
from different generators, so the comparison is of behaviour, not of
bits. --fe_seed seeds the front-end's RANSAC generator in both packages
(PRNGKey(seed) for the reference, a torch generator for the port; 7 is
both packages' default), --only runs one package and prints its rows,
--device runs the port on the card (the reference always on the CPU).
--input_folder and --bound run a real-data config (its reader) on a
sequence in its layout, e.g. chip_smoke.write_tum_fixture's TUM-layout
room with the bound it returns, under configs/TUM_RGBD/tum_imap.yaml.
--frame_cache DIR keeps the synthetic frames' ray casts in DIR
(data.frame_cache_dir; both packages' readers share its files), so runs
over many seeds cast each frame once. --cpu_draws draws the port's RANSAC
hypotheses from a CPU generator on either device (as
scripts/twoview_draws_probe.py --cpu_draws), so a card run and a CPU run
of the front-end solve from the same hypotheses.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(load_config, args):
    cfg = load_config(os.path.join(REPO, args.config))
    cfg["rendering"]["megakernel"] = "off"
    cfg["mapping"].update(fused_outer=True, resample_every=4,
                          color_refine=False, pixels=args.pixels,
                          iters_first=args.iters_first)
    cfg["tracking"].update(pixels=args.pixels, resample_every=5)
    cfg["data"]["frame_cache_dir"] = args.frame_cache or ""
    if args.input_folder:
        cfg["data"]["input_folder"] = args.input_folder
        cfg["mapping"]["bound"] = json.loads(args.bound)
    cfg["verbose"] = False
    return cfg


def summary(slam, tracking) -> dict:
    """{frame: record} of the tracked frames: tracking loss, t err, and in
    weak mode the front-end's solve and the scale telemetry."""
    import numpy as np
    est, gt = slam.estimate_c2w_list, slam.gt_c2w_list
    out = {}
    for idx, first, best in tracking:
        out[idx] = {"first": first, "best": best, "t_err_mm": float(
            np.linalg.norm(est[idx][:3, 3] - gt[idx][:3, 3])) * 1000}
    for t in slam.scale_telemetry:
        if t.get("c_gt") is None:
            continue
        g = np.asarray(t["c_gt"])
        rec = out.setdefault(t["idx"], {})
        ref = t.get("ref_idx", -1)
        # step length against gt's from the reference frame, as
        # scripts/_analyze_scale_telemetry.py reads a checkpoint
        b_gt = float(np.linalg.norm(g - gt[ref][:3, 3])) if ref >= 0 \
            else 0.0
        for k in ("c_prior", "c_solve", "c_refined"):
            rec[k[2:] + "_mm"] = None if t.get(k) is None else float(
                np.linalg.norm(np.asarray(t[k]) - g)) * 1000
            if t.get(k) is not None and b_gt > 1e-9:
                rec[k[2:] + "_ratio"] = float(np.linalg.norm(
                    np.asarray(t[k]) - est[ref][:3, 3])) / b_gt
    fe = getattr(slam, "frontend", None)
    for t in (fe.telemetry if fe is not None else []):
        rec = out.setdefault(int(t["idx"]), {})
        if "rejected_step" in t or "rejected_step_abs" in t:
            rec["rejected"] = True
        else:
            rec.update({k: t[k] for k in ("n_matches", "n_inliers",
                                          "n_cand", "parallax", "par_eff",
                                          "scale", "ref_idx") if k in t})
            if "ref_idx" not in t:      # the bootstrap's record
                rec["bootstrap"] = True
    return out


def run_jax(args) -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pointnerf_slam_tpu.engine import PointNeRFSLAM
    from pointnerf_slam_tpu.io.config import load_config
    slam = PointNeRFSLAM(config(load_config, args), n_frames_cap=args.frames)
    if slam.frontend is not None:
        slam.frontend.key = jax.random.PRNGKey(args.fe_seed)
    for idx in range(args.frames):
        _, color, depth, gt = slam.frame_reader[idx]
        slam.step(idx, color, depth, gt)
        slam._commit_pending_pose()
    return summary(slam, [(int(i), float(f), float(b))
                          for i, f, b in slam.loss_log["tracking"]])


def system_with_draws(args, PointNeRFSLAM, Draws, load_config):
    """The port's system for args, its front-end's RANSAC generator seeded
    args.fe_seed; with args.cpu_draws every draw from CPU generators."""
    import torch
    slam = PointNeRFSLAM(config(load_config, args), n_frames_cap=args.frames,
                         device=args.device)
    dev = slam.device

    class OnDevice(Draws):
        def take(self, make):
            out = super().take(make)
            return tuple(None if t is None else t.to(dev) for t in out) \
                if isinstance(out, tuple) else out.to(dev)

    if args.cpu_draws:
        slam.draws = OnDevice(torch.Generator().manual_seed(
            slam.cfg.get("seed", 1219) + 1))
        from pointnerf_slam_torch.frontend import fused_twoview as T
        draw = T.draw_hypotheses
        T.draw_hypotheses = lambda g, mv: draw(g, mv.cpu()).to(mv.device)
    if slam.frontend is not None:
        slam.frontend.draws = Draws(torch.Generator(
            device="cpu" if args.cpu_draws else dev).manual_seed(
                args.fe_seed))
    return slam


def run_torch(args) -> dict:
    import torch
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))))
    from pointnerf_slam_torch.engine import PointNeRFSLAM
    from pointnerf_slam_torch.engine.state import Draws
    from pointnerf_slam_torch.io.config import load_config
    slam = system_with_draws(args, PointNeRFSLAM, Draws, load_config)
    slam.run()
    return summary(slam, [(r["idx"], float(r["track_first"]),
                           float(r["track_best"]))
                          for r in slam.frame_log if "track_first" in r])


def fmt(rec, keys):
    out = []
    for k in keys:
        v = rec.get(k)
        out.append("-" if v is None else f"{v:.2f}" if isinstance(v, float)
                   else str(v))
    return " / ".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/Synthetic/room_bench.yaml")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--pixels", type=int, default=1000)
    ap.add_argument("--iters_first", type=int, default=300)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fe_seed", type=int, default=7)
    ap.add_argument("--only", choices=("jax", "torch"), default=None)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--input_folder", default=None)
    ap.add_argument("--bound", default=None)
    ap.add_argument("--frame_cache", default=None)
    ap.add_argument("--cpu_draws", action="store_true")
    ap.add_argument("--package", choices=("jax", "torch"), default=None,
                    help=argparse.SUPPRESS)   # one package, in a subprocess
    args = ap.parse_args()
    if args.package:
        res = (run_jax if args.package == "jax" else run_torch)(args)
        print("RESULT " + json.dumps(res), flush=True)
        return 0
    results = {"jax": {}, "torch": {}}
    for pkg in (args.only,) if args.only else ("jax", "torch"):
        cmd = [sys.executable, os.path.abspath(__file__), "--package", pkg,
               "--config", args.config, "--frames", str(args.frames),
               "--pixels", str(args.pixels),
               "--iters_first", str(args.iters_first),
               "--fe_seed", str(args.fe_seed), "--device", args.device]
        if args.input_folder:
            cmd += ["--input_folder", args.input_folder, "--bound",
                    args.bound]
        if args.frame_cache:
            cmd += ["--frame_cache", args.frame_cache]
        if args.cpu_draws:
            cmd.append("--cpu_draws")
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
        out = subprocess.run(cmd, env=env, capture_output=True, text=True)
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if out.returncode or not line:
            print(out.stdout[-3000:], out.stderr[-3000:], file=sys.stderr)
            return 1
        results[pkg] = {int(k): v for k, v in
                        json.loads(line[-1][len("RESULT "):]).items()}
    print(f"frames 0..{args.frames - 1} of {args.config}, full resolution "
          f"and decoder width, megakernel off, {args.pixels} tracking and "
          f"mapping pixels, iters_first {args.iters_first}, front-end "
          f"seed {args.fe_seed}, port on {args.device}")
    print("frame | jax first -> best | jax t err mm | torch first -> best "
          "| torch t err mm | torch - jax mm")
    nan = float("nan")
    for idx in sorted(set(results["jax"]) | set(results["torch"])):
        j, t = results["jax"].get(idx, {}), results["torch"].get(idx, {})
        je, te = j.get("t_err_mm", nan), t.get("t_err_mm", nan)
        print(f"{idx} | {j.get('first', nan):.2f} -> {j.get('best', nan):.2f}"
              f" | {je:.2f} | {t.get('first', nan):.2f} -> "
              f"{t.get('best', nan):.2f} | {te:.2f} | {te - je:+.2f}")
    keys = ("n_matches", "n_inliers", "n_cand", "parallax", "par_eff",
            "scale", "prior_mm", "solve_mm", "refined_mm", "rejected")
    if any("prior_mm" in r for pkg in results.values()
           for r in pkg.values()):
        print("front-end and scale telemetry per tracked frame: "
              + " / ".join(keys))
        for idx in sorted(set(results["jax"]) | set(results["torch"])):
            print(f"{idx} jax   {fmt(results['jax'].get(idx, {}), keys)}")
            print(f"{idx} torch {fmt(results['torch'].get(idx, {}), keys)}")
        for pkg, res in results.items():
            med = {k: statistics.median(r[k] for r in res.values()
                                        if r.get(k) is not None)
                   for k in ("prior_ratio", "solve_ratio", "refined_ratio")
                   if any(r.get(k) is not None for r in res.values())}
            if med:
                print(f"{pkg}: step-ratio medians (1 = gt's step length) "
                      + ", ".join(f"{k[:-6]} {v:.3f}"
                                  for k, v in med.items()))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
