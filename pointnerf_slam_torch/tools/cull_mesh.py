"""Cull a mesh to the camera frustums of a trajectory (the JAX reference's
tools/cull_mesh.py; prepares a ground-truth mesh for eval_recon):

  python -m pointnerf_slam_torch.tools.cull_mesh <mesh.ply>
      --traj <ckpt.npz | traj.txt> --out <culled.ply> [--save_unseen_pc]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..outputs.mesher import filter_mesh, read_ply, write_ply

# the reference's Replica intrinsics, which the synthetic room shares
REPLICA_INTRINSICS = dict(H=680, W=1200, fx=600.0, fy=600.0, cx=599.5,
                          cy=339.5)


def frustum_keep_mask(verts: np.ndarray, poses_c2w: np.ndarray,
                      H: int, W: int, fx: float, fy: float, cx: float,
                      cy: float) -> np.ndarray:
    """Per vertex: inside at least one camera's frustum (poses in the
    NeRF convention, camera -y / -z)."""
    keep = np.zeros(len(verts), bool)
    for c2w in poses_c2w:
        w2c = np.linalg.inv(c2w)
        pc = verts @ w2c[:3, :3].T + w2c[:3, 3]
        z = -pc[:, 2]
        ok = z > 1e-6
        u = pc[:, 0] / np.maximum(z, 1e-6) * fx + cx
        v = -pc[:, 1] / np.maximum(z, 1e-6) * fy + cy
        keep |= ok & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        if keep.all():
            break
    return keep


def cull_mesh(verts: np.ndarray, tris: np.ndarray, poses_c2w: np.ndarray,
              H: int, W: int, fx: float, fy: float, cx: float, cy: float):
    """The faces whose three vertices some frustum holds; reindexed."""
    keep = frustum_keep_mask(verts, poses_c2w, H, W, fx, fy, cx, cy)
    return filter_mesh(verts, tris, keep)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mesh")
    p.add_argument("--traj", required=True,
                   help="a checkpoint (.npz, its gt_c2w_list) or a Replica "
                        "traj.txt")
    p.add_argument("--out", required=True)
    p.add_argument("--save_unseen_pc", action="store_true",
                   help="also write {out%%.ply}_pc_unseen.npy: the vertices "
                        "outside every frustum, which eval_recon's 2D view "
                        "rejection reads")
    args = p.parse_args(argv)
    verts, tris, _ = read_ply(args.mesh)
    if args.traj.endswith(".npz"):
        poses = np.load(args.traj)["gt_c2w_list"]
    else:
        poses = np.loadtxt(args.traj).reshape(-1, 4, 4)
        poses[:, :3, 1] *= -1
        poses[:, :3, 2] *= -1
    keep = frustum_keep_mask(verts, poses, **REPLICA_INTRINSICS)
    v, t = filter_mesh(verts, tris, keep)
    write_ply(args.out, v, t)
    print(f"culled {len(verts)} -> {len(v)} vertices")
    if args.save_unseen_pc:
        pc_path = (args.out[:-4] if args.out.endswith(".ply")
                   else args.out) + "_pc_unseen.npy"
        np.save(pc_path, verts[~keep].astype(np.float32))
        print(f"wrote {pc_path} ({int((~keep).sum())} unseen points)")


if __name__ == "__main__":
    main()
