"""The exact ground-truth mesh of the procedural synthetic room (the JAX
reference's tools/make_synthetic_gt_mesh.py).

The room (io/synthetic.py) is analytic: a closed box seen from inside plus
the furniture boxes. The solid's signed field is sampled on a dense grid,
its zero level set extracted by the native marching tetrahedra
(outputs/mesher.marching_tets), and the vertices coloured with the scene's
procedural texture:

  python -m pointnerf_slam_torch.tools.make_synthetic_gt_mesh
      --out output/room_gt_mesh.ply --resolution 256
"""

from __future__ import annotations

import argparse

import numpy as np

from ..io.synthetic import SyntheticScene
from ..outputs.mesher import marching_tets, write_ply


def solid_field(scene: SyntheticScene, pts: np.ndarray) -> np.ndarray:
    """Positive inside the walls or any box, negative in the free space;
    the zero level is the visible surface."""
    out = np.max(np.abs(pts), axis=-1) - scene.room_half
    for lo, hi in scene.boxes:
        box = np.max(np.maximum(np.asarray(lo) - pts, pts - np.asarray(hi)),
                     axis=-1)
        out = np.maximum(out, -box)
    return out


def make_gt_mesh(resolution: int = 256, pad: float = 0.15):
    """(verts (V, 3) float32, tris (T, 3), colours (V, 3) uint8)."""
    scene = SyntheticScene()
    h = scene.room_half + pad
    axes = [np.linspace(-h, h, resolution, dtype=np.float32)] * 3
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    occ = solid_field(scene, pts).reshape((resolution,) * 3)
    verts_idx, tris = marching_tets(occ.astype(np.float32), 0.0)
    step = 2 * h / (resolution - 1)
    verts = verts_idx * step - h
    # the box tint marks vertices within a cell of any furniture box
    on_box = np.zeros(len(verts), bool)
    for lo, hi in scene.boxes:
        on_box |= np.all((verts >= np.asarray(lo) - step)
                         & (verts <= np.asarray(hi) + step), axis=-1)
    colors = np.clip(scene.color(verts, on_box) * 255, 0,
                     255).astype(np.uint8)
    return verts.astype(np.float32), tris, colors


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="output/room_gt_mesh.ply")
    p.add_argument("--resolution", type=int, default=256)
    args = p.parse_args(argv)
    verts, tris, colors = make_gt_mesh(args.resolution)
    write_ply(args.out, verts, tris, colors)
    print(f"wrote {args.out}: {len(verts)} verts, {len(tris)} tris")


if __name__ == "__main__":
    main()
