"""During-run live window, updated from the engine loop.

One matplotlib window, two panes, redrawn every `freq` frames:
  left  — 3D: estimated pose trail (+ gt trail), current camera marker,
          and the latest periodic mesh's vertices (read again whenever the
          mesher writes a new PLY, i.e. at mesh cadence);
  right — 2D: the current input frame.
Attach with `python -m pointnerf_slam_torch.run --live_vis`.

With no GUI backend (TkAgg or QtAgg) the viewer disables itself with a
notice and the run goes on unchanged; the offline replay viewer
(`python -m pointnerf_slam_torch.visualizer --interactive`) and the
TrajectoryWriter panels stand for it on a headless machine.
"""

from __future__ import annotations

import glob
import os

import numpy as np


class LiveViewer:
    """aux_visualizers-compatible: vis(slam, idx) from the engine loop."""

    def __init__(self, out_dir: str, freq: int = 5, every: int = 1,
                 max_mesh_pts: int = 20000):
        self.freq = max(freq, 1)
        self.every = every
        self.mesh_dir = os.path.join(out_dir, "mesh")
        self.max_mesh_pts = max_mesh_pts
        self._mesh_path = None
        self._mesh_verts = None
        self.enabled = False
        try:
            import matplotlib
            for backend in ("TkAgg", "QtAgg"):
                try:
                    matplotlib.use(backend)
                    import matplotlib.pyplot as plt
                    fig = plt.figure(figsize=(11, 5))
                    break
                except Exception:
                    continue
            else:
                raise RuntimeError("no GUI backend")
            self.plt = plt
            self.fig = fig
            self.ax3 = fig.add_subplot(121, projection="3d")
            self.ax2 = fig.add_subplot(122)
            plt.ion()
            plt.show(block=False)
            self.enabled = True
        except Exception as e:  # headless box: keep the run alive
            print(f"[live_vis] disabled ({e}); use python -m "
                  f"pointnerf_slam_torch.visualizer --interactive for "
                  f"offline replay")

    def _latest_mesh(self):
        meshes = sorted(glob.glob(os.path.join(self.mesh_dir, "*_mesh.ply")))
        if not meshes or meshes[-1] == self._mesh_path:
            return self._mesh_verts
        from .mesher import read_ply
        verts, _, _ = read_ply(meshes[-1])
        if len(verts) > self.max_mesh_pts:
            sel = np.linspace(0, len(verts) - 1, self.max_mesh_pts,
                              dtype=np.int64)
            verts = verts[sel]
        self._mesh_path, self._mesh_verts = meshes[-1], verts
        return verts

    def vis(self, slam, idx: int):
        if not self.enabled or idx % self.freq != 0:
            return
        if not self.plt.fignum_exists(self.fig.number):
            self.enabled = False  # user closed the window
            return
        est = slam.estimate_c2w_list[: idx + 1, :3, 3]
        gt = slam.gt_c2w_list[: idx + 1, :3, 3]
        ax = self.ax3
        ax.cla()
        verts = self._latest_mesh()
        if verts is not None:
            ax.scatter(verts[:, 0], verts[:, 1], verts[:, 2], s=0.3,
                       c=verts[:, 2], cmap="viridis", alpha=0.35,
                       linewidths=0)
        if np.abs(gt).max() > 0:
            ax.plot(gt[:, 0], gt[:, 1], gt[:, 2], "g-", lw=1, label="gt")
        ax.plot(est[:, 0], est[:, 1], est[:, 2], "r-", lw=1.5, label="est")
        ax.scatter(*est[-1], color="red", marker="^", s=60)
        ax.legend(loc="upper right")
        ax.set_title(f"frame {idx}")

        frame = getattr(slam, "_frame_dev", None)
        if frame is not None and frame[0] == idx:
            img = frame[3]  # u8 colour
            img = img.cpu().numpy() if hasattr(img, "cpu") else np.asarray(img)
            self.ax2.cla()
            self.ax2.imshow(img[:: self.every, :: self.every])
            self.ax2.set_axis_off()
            self.ax2.set_title("current frame")
        self.fig.canvas.draw_idle()
        self.fig.canvas.flush_events()
