"""Per-event render panels.

Renders the full image at the frame's pose (render.renderer.render_img,
with the sensor or pseudo depth as the depth prior) and saves a 2x3
matplotlib panel (input depth / rendered depth / depth residual; input
colour / rendered colour / colour residual) as {vis_dir}/{idx:05d}.jpg at
every `freq`-th frame (drawn with cv2 where matplotlib is not installed:
outputs.draw.plain_image_panel). The engine calls one for mapping (mapping_vis/, at
mapping.vis_freq) and one for tracking (tracking_vis/, at
tracking.vis_freq); both render per event, not per optimizer iteration.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class Visualizer:
    def __init__(self, freq: int, vis_dir: str, verbose: bool = False):
        self.freq = max(int(freq), 1)
        self.vis_dir = vis_dir
        self.verbose = verbose
        os.makedirs(vis_dir, exist_ok=True)

    def vis(self, slam, idx: int, gt_depth, gt_color, c2w44):
        if idx % self.freq != 0:
            return
        from ..render.renderer import render_img
        from .draw import plain_image_panel, pyplot, save_image

        depth, _, color = render_img(
            slam.decoder, slam.rcfg, slam.H, slam.W, slam.fx, slam.fy,
            slam.cx, slam.cy, np.asarray(c2w44, np.float32), slam.bound,
            gt_depth=np.asarray(gt_depth, np.float32),
            c_grid=slam.c_grid if slam.nice else None)
        depth = depth.cpu().numpy()
        color = np.clip(color.cpu().numpy(), 0, 1)
        gt_depth = (gt_depth.cpu().numpy() if torch.is_tensor(gt_depth)
                    else np.asarray(gt_depth))
        gt_color = (gt_color.cpu().numpy() if torch.is_tensor(gt_color)
                    else np.asarray(gt_color))
        depth_res = np.abs(gt_depth - depth)
        depth_res[gt_depth == 0] = 0
        color_res = np.abs(gt_color - color).mean(-1)

        vmax = max(float(gt_depth.max()), 1e-6)
        out = os.path.join(self.vis_dir, f"{idx:05d}.jpg")
        plt = pyplot()
        if plt is None:
            save_image(out, plain_image_panel([
                (gt_depth, "Input Depth", vmax),
                (depth, "Generated Depth", vmax),
                (depth_res, "Depth Residual", vmax),
                (gt_color, "Input RGB", None), (color, "Generated RGB", None),
                (color_res, "RGB Residual", 1.0)], cols=3))
            return
        fig, axs = plt.subplots(2, 3, figsize=(12, 6))
        for ax, (img, title, kw) in zip(axs.flat, [
            (gt_depth, "Input Depth", {"cmap": "plasma", "vmax": vmax}),
            (depth, "Generated Depth", {"cmap": "plasma", "vmax": vmax}),
            (depth_res, "Depth Residual", {"cmap": "plasma", "vmax": vmax}),
            (gt_color, "Input RGB", {}),
            (color, "Generated RGB", {}),
            (color_res, "RGB Residual", {"cmap": "plasma", "vmax": 1.0}),
        ]):
            ax.imshow(img, **kw)
            ax.set_title(title)
            ax.axis("off")
        fig.savefig(out, dpi=100, bbox_inches="tight")
        plt.close(fig)
        if self.verbose:
            print(f"Visualizer: saved {out}")
