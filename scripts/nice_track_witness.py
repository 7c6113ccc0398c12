#!/usr/bin/env python3
"""Both packages' NICE trackers on one map, from a shifted start.

  python scripts/nice_track_witness.py make OUT [--device cuda]
  python scripts/nice_track_witness.py track CKPT [--frames 0 10]
      [--rounds 20] [--shift 0.02] [--seed 100] [--out result.json]

`make` runs the port's NICE system at full width (configs/Synthetic/
room_bench.yaml with configs/nice_slam.yaml's keys overlaid, colour
refine off: chip_smoke.py's NICE phase) over frames 0..10 and writes its
frame-10 checkpoint to OUT/ckpts/00010.npz.

`track` loads that checkpoint into the JAX reference and into the port
(each package's own resume_slam, each in its own subprocess, both on the
CPU), and for each frame F of --frames shifts the gt camera by --shift m
along +y, then calls the package's NICE tracking step --rounds times
(tracking.pixels rays x tracking.iters iterations a call), each call
from the last call's best camera. The reference draws its pixels from
PRNGKey(seed + round); the port replays those draws (written by the
reference's process), so the two trackers see the same pixels. Prints
per round and package the translation error against gt in mm and the
call's first and best loss, and writes every row to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
FRAMES = 11


def nice_config(load_config, update_recursive):
    import yaml
    cfg = load_config(os.path.join(REPO, "configs/Synthetic/room_bench.yaml"))
    with open(os.path.join(REPO, "configs/nice_slam.yaml")) as fh:
        update_recursive(cfg, yaml.safe_load(fh))
    cfg["data"]["frame_cache_dir"] = ""
    cfg["mapping"]["color_refine"] = False
    return cfg


def make(args):
    import torch
    from pointnerf_slam_torch.engine import PointNeRFSLAM
    from pointnerf_slam_torch.io.config import load_config, update_recursive
    from pointnerf_slam_torch.outputs.logger import Logger
    slam = PointNeRFSLAM(nice_config(load_config, update_recursive),
                         n_frames_cap=FRAMES, device=args.device)
    slam.run()
    if slam.device.type == "cuda":
        torch.cuda.synchronize()
    for rec in slam.frame_log:
        if "t_err_m" in rec:
            print(f"frame {rec['idx']}: t err "
                  f"{float(rec['t_err_m']) * 1000:.2f} mm", flush=True)
    Logger(args.path, 1, slam.n_img).log(slam, slam.n_img - 1)
    print(f"wrote {os.path.join(args.path, 'ckpts')}", flush=True)


def shifted(gt, shift):
    import numpy as np
    start = np.asarray(gt, np.float64).copy()
    start[1, 3] += shift
    return start


def track_jax(args, draws_path):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from pointnerf_slam_tpu.core.rays import sample_uv_uniform
    from pointnerf_slam_tpu.engine import PointNeRFSLAM
    from pointnerf_slam_tpu.io.config import load_config, update_recursive
    from pointnerf_slam_tpu.outputs.logger import resume_slam
    slam = PointNeRFSLAM(nice_config(load_config, update_recursive),
                         n_frames_cap=FRAMES)
    resume_slam(slam, args.path)
    e = slam.ecfg
    rows, draws = [], {}
    for f in args.frames:
        _, color, depth, gt = slam.frame_reader[f]
        c, _, _ = slam._upload_frame(f, color, depth)
        d = slam._supervising_depth(f, depth)
        cam = slam._cam7(shifted(gt, args.shift))
        for r in range(args.rounds):
            key = jax.random.PRNGKey(args.seed + r)
            draws[f"{f}_{r}"] = np.stack([np.asarray(sample_uv_uniform(
                jax.random.split(k)[0], e.W, e.ignore_edge_H,
                e.H - e.ignore_edge_H, e.ignore_edge_W,
                e.W - e.ignore_edge_W, e.tracking_pixels))
                for k in jax.random.split(key, e.num_cam_iters)])
            cam, best, first = slam.tracking_step(
                slam.params, slam.c_grid, cam, c, d, slam.bound, key)
            cam = np.asarray(cam)
            rows.append(row("jax", f, r, cam, slam._cam7(gt), first, best))
    np.savez(draws_path, **draws)
    return rows


def track_torch(args, draws_path):
    import numpy as np
    import torch
    from pointnerf_slam_torch.engine import PointNeRFSLAM
    from pointnerf_slam_torch.engine.state import Draws
    from pointnerf_slam_torch.io.config import load_config, update_recursive
    from pointnerf_slam_torch.outputs.logger import resume_slam
    slam = PointNeRFSLAM(nice_config(load_config, update_recursive),
                         n_frames_cap=FRAMES, device="cpu")
    resume_slam(slam, args.path)
    z = np.load(draws_path)
    rows = []
    for f in args.frames:
        _, color, depth, gt = slam.frame_reader[f]
        c, d, _ = slam._upload_frame(f, color, depth)
        d = slam._supervising_depth(f, d)
        cam = slam._cam7(shifted(gt, args.shift))
        for r in range(args.rounds):
            replay = [torch.as_tensor(i).long() for i in z[f"{f}_{r}"]]
            cam, best, first, _ = slam.tracking_step(
                slam.decoder, cam, c, d, slam.bound, Draws(replay=replay),
                slam.c_grid)
            rows.append(row("torch", f, r, cam.numpy(),
                            slam._cam7(gt).numpy(), first, best))
    return rows


def row(package, frame, rnd, cam, gt7, first, best):
    import numpy as np
    cam, gt7 = np.asarray(cam, np.float64), np.asarray(gt7, np.float64)
    return {"package": package, "frame": frame, "round": rnd,
            "t_err_mm": float(np.linalg.norm(cam[4:] - gt7[4:]) * 1000),
            "first_loss": float(first), "best_loss": float(best)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("make", "track"))
    ap.add_argument("path", help="make: output folder; track: checkpoint")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, nargs="+", default=[0, 10])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--shift", type=float, default=0.02)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--out", default="")
    ap.add_argument("--only", choices=("jax", "torch"), default="",
                    help=argparse.SUPPRESS)
    ap.add_argument("--draws", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mode == "make":
        return make(args)
    if args.only:
        fn = track_jax if args.only == "jax" else track_torch
        print(json.dumps(fn(args, args.draws)))
        return
    rows = []
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        draws = os.path.join(tmp, "draws.npz")
        for pkg in ("jax", "torch"):
            cmd = [sys.executable, os.path.abspath(__file__), "track",
                   args.path, "--only", pkg, "--draws", draws,
                   "--rounds", str(args.rounds), "--shift", str(args.shift),
                   "--seed", str(args.seed), "--frames",
                   *map(str, args.frames)]
            out = subprocess.run(cmd, cwd=REPO, check=True,
                                 capture_output=True, text=True).stdout
            rows += json.loads(out.strip().splitlines()[-1])
    for f in args.frames:
        print(f"frame {f}, from +{args.shift * 1000:.1f} mm along y:")
        by = {p: [x for x in rows if x["frame"] == f and x["package"] == p]
              for p in ("jax", "torch")}
        for rj, rt in zip(by["jax"], by["torch"]):
            print(f"  round {rj['round']:2d}: t err jax "
                  f"{rj['t_err_mm']:8.3f} mm, torch {rt['t_err_mm']:8.3f} "
                  f"mm; loss first -> best jax {rj['first_loss']:.2f} -> "
                  f"{rj['best_loss']:.2f}, torch {rt['first_loss']:.2f} -> "
                  f"{rt['best_loss']:.2f}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
