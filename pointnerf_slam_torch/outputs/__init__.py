"""Run outputs: the checkpoint logger (outputs/logger.py), the mesher
(outputs/mesher.py, outputs/tsdf.py), the render panels
(outputs/visualizer.py), the match, trajectory and loss-curve writers
(outputs/draw.py) and the live window (outputs/live_view.py)."""

from __future__ import annotations

import os

from .draw import LossCurveWriter, MatchVisualizer, TrajectoryWriter
from .logger import Logger
from .mesher import Mesher
from .visualizer import Visualizer


def attach_outputs(slam):
    """Wire the logger, the mesher and the five writers into a
    PointNeRFSLAM, as the reference's attach_outputs does.
    PointNeRFSLAM.run then, for every frame, banks the state up to the
    previous frame before a mapping frame (logger.log(idx - 1)),
    checkpoints at mapping.ckpt_freq and at the last frame
    (logger.maybe_log; <output>/ckpts/{idx:05d}.npz), calls
    mesher.maybe_mesh (periodic meshes at mapping.mesh_freq, the final mesh
    and, with meshing.eval_rec, the eval mesh into <output>/mesh/), and
    the writers:
      - mapping_vis/{idx:05d}.jpg: the render panel of frame idx > 0 at
        mapping.vis_freq (after the frame's step);
      - tracking_vis/{idx:05d}.jpg: the render panel of a tracked frame at
        tracking.vis_freq (right after its tracking, at the committed
        pose);
      - matches_vis/{idx:05d}.jpg (weak mode): the front-end's matches at
        tracking.vis_freq;
      - traj_vis/{idx:05d}.png and loss_vis/loss_curves.png at
        mapping.vis_freq.
    It flushes the mesher at the end.

    In a data-parallel run (slam.group of several ranks) only rank 0 is
    wired; every rank commits its tracked poses as rank 0's tracking panel
    does, so the ranks' windows stay equal."""
    slam.commit_tracked_pose = True
    if slam.group.rank != 0:
        return slam
    cfg = slam.cfg
    m = cfg["mapping"]
    slam.logger = Logger(slam.output, m["ckpt_freq"], slam.n_img,
                         m["no_log_on_first_frame"])
    os.makedirs(os.path.join(slam.output, "mesh"), exist_ok=True)
    slam.mesher = Mesher(cfg, slam)
    slam.visualizer = Visualizer(m["vis_freq"],
                                 os.path.join(slam.output, "mapping_vis"),
                                 slam.verbose)
    slam.tracking_visualizer = Visualizer(
        cfg["tracking"]["vis_freq"],
        os.path.join(slam.output, "tracking_vis"), slam.verbose)
    if slam.frontend is not None:
        slam.match_visualizer = MatchVisualizer(
            cfg["tracking"]["vis_freq"],
            os.path.join(slam.output, "matches_vis"), slam.verbose)
    slam.aux_visualizers = [
        TrajectoryWriter(m["vis_freq"], os.path.join(slam.output, "traj_vis"),
                         slam.verbose),
        LossCurveWriter(m["vis_freq"], os.path.join(slam.output, "loss_vis"),
                        slam.verbose)]
    return slam
