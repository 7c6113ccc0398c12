"""Offline trajectory and mesh replay of a run.

  python -m pointnerf_slam_torch.visualizer --output DIR [--ckpt NPZ]
      [--every 10] [--save_rendering] [--no_gt_traj] [--interactive]

Replays a checkpoint's estimated and gt trajectories and the run's
periodic meshes (DIR/ckpts/*.npz, DIR/mesh/*_mesh.ply; the latest
checkpoint unless --ckpt) into rendered frames, DIR/vis_replay/{idx:05d}.png
every --every frames: a 3-D plot of the trajectories up to the frame and
the vertices of the latest mesh written by then. --save_rendering
assembles them into DIR/vis.mp4 (imageio; skipped with a notice where it
or its ffmpeg is missing).

--interactive opens a live matplotlib window instead: space pauses and
resumes, the left and right arrows step, q quits. Without a GUI backend it
renders offline as above, with a notice.
"""

import argparse
import glob
import os

import numpy as np


def draw_frame(ax, verts, est_traj, gt_traj, idx):
    ax.clear()
    if verts is not None and len(verts):
        sub = verts[:: max(len(verts) // 20000, 1)]
        ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=0.1, c=sub[:, 2],
                   cmap="viridis", alpha=0.5)
    if gt_traj is not None:
        ax.plot(*gt_traj[: idx + 1].T, "g-", label="gt", linewidth=1)
    ax.plot(*est_traj[: idx + 1].T, "r-", label="estimate", linewidth=1)
    ax.scatter(*est_traj[idx], c="red", s=30, marker="o")
    ax.set_title(f"frame {idx}")
    ax.legend(loc="upper right")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--output", required=True,
                   help="run output dir containing ckpts/ and mesh/")
    p.add_argument("--ckpt", default=None, help="specific ckpt npz")
    p.add_argument("--every", type=int, default=10)
    p.add_argument("--save_rendering", action="store_true")
    p.add_argument("--no_gt_traj", action="store_true")
    p.add_argument("--interactive", action="store_true",
                   help="live matplotlib window (space=pause, arrows=step, "
                        "q=quit); falls back to offline render headless")
    args = p.parse_args(argv)

    import matplotlib
    if args.interactive:
        try:
            matplotlib.use("TkAgg")
        except Exception:
            try:
                matplotlib.use("QtAgg")
            except Exception:
                print("no GUI backend available; falling back to offline "
                      "rendering")
                args.interactive = False
                matplotlib.use("Agg")
    else:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .outputs.mesher import read_ply

    ckpts = sorted(glob.glob(os.path.join(args.output, "ckpts", "*.npz")))
    ckpt = args.ckpt or (ckpts[-1] if ckpts else None)
    assert ckpt, f"no checkpoints under {args.output}/ckpts"
    z = np.load(ckpt)
    est = z["estimate_c2w_list"][:, :3, 3]
    gt = None if args.no_gt_traj else z["gt_c2w_list"][:, :3, 3]
    n = int(z["idx"]) + 1

    meshes = sorted(glob.glob(os.path.join(args.output, "mesh",
                                           "*_mesh.ply")))
    mesh_by_idx = {int(os.path.basename(m).split("_")[0]): m for m in meshes}

    def mesh_at(idx, cur):
        avail = [k for k in mesh_by_idx if k <= idx]
        if avail:
            v, _, _ = read_ply(mesh_by_idx[max(avail)])
            return v
        return cur

    if args.interactive:
        # live replay loop: the window owns the cadence; keys steer it
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(111, projection="3d")
        state = {"idx": 0, "paused": False, "quit": False}

        def on_key(ev):
            if ev.key == " ":
                state["paused"] = not state["paused"]
            elif ev.key == "right":
                state["idx"] = min(state["idx"] + args.every, n - 1)
            elif ev.key == "left":
                state["idx"] = max(state["idx"] - args.every, 0)
            elif ev.key == "q":
                state["quit"] = True

        fig.canvas.mpl_connect("key_press_event", on_key)
        plt.ion()
        plt.show()
        verts = None
        while not state["quit"] and plt.fignum_exists(fig.number):
            verts = mesh_at(state["idx"], verts)
            draw_frame(ax, verts, est, gt, state["idx"])
            fig.canvas.draw_idle()
            plt.pause(0.05)
            if not state["paused"]:
                if state["idx"] + args.every >= n:
                    state["paused"] = True
                else:
                    state["idx"] += args.every
        return

    out_dir = os.path.join(args.output, "vis_replay")
    os.makedirs(out_dir, exist_ok=True)
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    verts = None
    frames = []
    for idx in range(0, n, args.every):
        verts = mesh_at(idx, verts)
        draw_frame(ax, verts, est, gt, idx)
        path = os.path.join(out_dir, f"{idx:05d}.png")
        fig.savefig(path, dpi=90)
        frames.append(path)
        print(f"replay frame {idx} -> {path}")

    if args.save_rendering and frames:
        try:
            import imageio.v2 as imageio
            mp4 = os.path.join(args.output, "vis.mp4")
            with imageio.get_writer(mp4, fps=10) as w:
                for f in frames:
                    w.append_data(imageio.imread(f))
            print(f"wrote {mp4}")
        except Exception as e:  # imageio/ffmpeg optional
            print(f"mp4 assembly skipped: {e}")


if __name__ == "__main__":
    main()
