"""Emit a run config for self-captured data (the JAX reference's
tools/prep_own_data.py): intrinsics json + scene bound -> an `azure`
dataset YAML.

  python -m pointnerf_slam_torch.tools.prep_own_data --intrinsic_json J
      --input_folder DIR --output OUT --config_out YAML
      [--bound x0 x1 y0 y1 z0 z1 | --mesh PLY] [--png_depth_scale S]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--intrinsic_json", required=True,
                   help="camera intrinsics json (open3d layout: width, "
                        "height, intrinsic_matrix column-major)")
    p.add_argument("--input_folder", required=True)
    p.add_argument("--output", required=True, help="run output dir")
    p.add_argument("--config_out", required=True)
    p.add_argument("--bound", type=float, nargs=6, default=None,
                   metavar=("x0", "x1", "y0", "y1", "z0", "z1"))
    p.add_argument("--mesh", default=None,
                   help="optional reconstructed mesh ply to derive the bound")
    p.add_argument("--png_depth_scale", type=float, default=1000.0)
    args = p.parse_args(argv)

    with open(args.intrinsic_json) as f:
        intr = json.load(f)
    W, H = intr["width"], intr["height"]
    m = np.asarray(intr["intrinsic_matrix"]).reshape(3, 3).T  # column-major
    fx, fy, cx, cy = m[0, 0], m[1, 1], m[0, 2], m[1, 2]

    if args.bound is not None:
        b = np.asarray(args.bound).reshape(3, 2)
    elif args.mesh:
        from ..outputs.mesher import read_ply
        v, _, _ = read_ply(args.mesh)
        lo = v.min(0) - 0.5
        hi = v.max(0) + 0.5
        b = np.stack([lo, hi], 1)
    else:
        b = np.array([[-5, 5], [-5, 5], [-5, 5]], float)

    bound = [[round(float(x), 2) for x in row] for row in b]
    yaml = f"""inherit_from: configs/pointnerf_slam.yaml
data:
  dataset: azure
  input_folder: {args.input_folder}
  output: {args.output}
mapping:
  bound: {bound}
  marching_cubes_bound: {bound}
cam:
  H: {H}
  W: {W}
  fx: {fx}
  fy: {fy}
  cx: {cx}
  cy: {cy}
  png_depth_scale: {args.png_depth_scale}
  crop_edge: 0
"""
    with open(args.config_out, "w") as f:
        f.write(yaml)
    print(f"wrote {args.config_out}")


if __name__ == "__main__":
    main()
