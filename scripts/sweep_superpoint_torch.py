#!/usr/bin/env python3
"""Distillation sweep for the SuperPoint checkpoint, on the port
(the counterpart of scripts/sweep_superpoint.py).

  python scripts/sweep_superpoint_torch.py [--quick] [--device cuda|cpu]
      [--out_dir DIR]

Each candidate of the four-point grid: train on the in-repo synthetic
corpus (tools/train_superpoint.py; --quick 1500 steps on 48 images, else
4000 on 128), then its homography match precision, then the gating
metric, the weak bootstrap's median relative pseudo-depth error at frame
5 of an 11-frame weak run (Harris reads ~0.12; target <= 0.15). The
candidates' npz files and the JSON of the scores, sorted best first, go
under --out_dir (default output/sp_sweep). The winner is printed with the
command that would promote it; the script never writes
pretrained/superpoint_synthetic.npz, which the tests pin.

Runs on the card unless --device cpu; the port alone (no JAX).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GRID = [
    dict(name="run_scale", m_neg=0.2, lambda_d=250.0, mag=0.15),
    dict(name="hard_neg", m_neg=0.3, lambda_d=250.0, mag=0.15),
    dict(name="wide_homo", m_neg=0.2, lambda_d=250.0, mag=0.25),
    dict(name="bal_desc", m_neg=0.2, lambda_d=400.0, mag=0.15),
]
SIZES = {True: (1500, 48), False: (4000, 128)}   # --quick: (steps, images)
BOOT_FRAMES = 11            # the weak run's frames; the metric reads 5
PROMOTE_TO = "pretrained/superpoint_synthetic.npz"


def weak_cfg() -> dict:
    """tests/test_weak_pipeline.py's weak_cfg (on tests/test_engine.py's
    tiny_cfg), built on the port's defaults: that module imports the JAX
    package."""
    from pointnerf_slam_torch.io.config import (DEFAULT_CONFIG,
                                                update_recursive)
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    update_recursive(cfg, {
        "scale": 1.0,
        "weak_depth": False,
        "depth_supervision": True,
        "verbose": False,
        "cam": {"H": 40, "W": 52, "fx": 30.0, "fy": 30.0, "cx": 25.5,
                "cy": 19.5, "crop_edge": 0},
        "model": {"hidden_size": 32, "n_blocks": 2},
        "rendering": {"N_samples": 12, "N_surface": 0, "N_importance": 4},
        "mapping": {"bound": [[-2.2, 2.2], [-2.2, 2.2], [-2.2, 2.2]],
                    "marching_cubes_bound": [[-2.2, 2.2]] * 3,
                    "pixels": 400, "iters": 60, "iters_first": 200,
                    "every_frame": 2, "keyframe_every": 4,
                    "mapping_window_size": 3, "color_refine": False},
        "tracking": {"pixels": 300, "iters": 12, "lr": 2e-3,
                     "gt_camera": False},
        "data": {"dataset": "synthetic", "n_frames": 9,
                 "output": "/tmp/tpu_slam_test"},
        "track_every_frame": 1,
    })
    update_recursive(cfg, dict(
        weak_depth=True,
        depth_supervision=True,
        track_every_frame=5,
        bootstrap_min_cand=16,
        cam={"H": 120, "W": 160, "fx": 90.0, "fy": 90.0,
             "cx": 79.5, "cy": 59.5},
        data={"dataset": "synthetic", "n_frames": 16, "orbit": 0.12,
              "output": "/tmp/tpu_slam_weak_test"},
        mapping={"every_frame": 5, "pixels": 400, "iters": 45,
                 "iters_first": 150, "mapping_window_size": 3,
                 "keyframe_every": 5, "color_refine": False},
        tracking={"pixels": 300, "iters": 10, "lr": 2e-3},
    ))
    return cfg


def bootstrap_metric(ckpt_path: str, device, out_dir: str) -> float:
    """Median relative pseudo-depth error of the weak bootstrap at frame 5
    against the sensor depth the run never sees (inf without a bootstrap
    or with fewer than 50 pseudo-depth pixels)."""
    from pointnerf_slam_torch.engine import PointNeRFSLAM
    cfg = weak_cfg()
    cfg["superpoint_weights"] = ckpt_path
    cfg["data"]["n_frames"] = BOOT_FRAMES
    cfg["data"]["output"] = out_dir
    slam = PointNeRFSLAM(cfg, device=device)
    slam.run()
    if 5 not in slam.pseudo_depths:
        return float("inf")
    p5 = slam.pseudo_depths[5].detach().cpu().numpy()
    m = p5 > 0.01
    if m.sum() < 50:
        return float("inf")
    _, _, d5, _ = slam.frame_reader[5]
    rel = np.abs(p5[m] - d5[m]) / d5[m]
    return float(np.median(rel))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out_dir", default=os.path.join("output", "sp_sweep"))
    args = ap.parse_args(argv)

    from pointnerf_slam_torch.frontend.features import save_superpoint_npz
    from pointnerf_slam_torch.tools.train_superpoint import (evaluate,
                                                             render_corpus,
                                                             train)
    from pointnerf_slam_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    steps, n_img = SIZES[args.quick]
    corpus = render_corpus(n_img, seed=0, match_run_scale=True)
    os.makedirs(args.out_dir, exist_ok=True)
    results = []
    for g in GRID:
        print(f"=== {g['name']} ===", flush=True)
        net, _ = train(steps=steps, batch=4, lr=1e-3, corpus=corpus,
                       m_neg=g["m_neg"], lambda_d=g["lambda_d"],
                       mag=g["mag"], log_every=max(steps // 8, 1),
                       device=device)
        ck = os.path.join(args.out_dir, g["name"] + ".npz")
        save_superpoint_npz(ck, net.params())
        acc, tot = evaluate(net, corpus)
        tri = bootstrap_metric(ck, device,
                               os.path.join(args.out_dir, "boot_" + g["name"]))
        print(f"{g['name']}: homography {acc:.3f} ({tot}), "
              f"bootstrap median rel err {tri:.3f}", flush=True)
        results.append({**g, "homography": acc, "tri": tri, "ckpt": ck})

    results.sort(key=lambda r: r["tri"])
    out_json = os.path.join(args.out_dir, "sp_sweep.json")
    with open(out_json, "w") as fh:
        json.dump(results, fh, indent=1)
    best = results[0]
    print(f"best: {best['name']} tri={best['tri']:.3f} -> {best['ckpt']} "
          f"(all scores: {out_json})")
    print(f"(promote with: cp {best['ckpt']} {PROMOTE_TO})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
