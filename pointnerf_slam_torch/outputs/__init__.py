"""Run outputs: the checkpoint logger (outputs/logger.py) and the mesher
(outputs/mesher.py, outputs/tsdf.py).

The visualizers of the JAX reference's outputs/ (mapping and tracking
panels, match and trajectory drawings, loss curves, the live view) are not
ported (ROADMAP Queue 1 item 11)."""

from __future__ import annotations

import os

from .logger import Logger
from .mesher import Mesher


def attach_outputs(slam):
    """Wire the logger and the mesher into a PointNeRFSLAM, as the
    reference's attach_outputs does. PointNeRFSLAM.run then, for every
    frame, banks the state up to the previous frame before a mapping frame
    (logger.log(idx - 1)), checkpoints at mapping.ckpt_freq and at the
    last frame (logger.maybe_log; <output>/ckpts/{idx:05d}.npz), and calls
    mesher.maybe_mesh (periodic meshes at mapping.mesh_freq, the final mesh
    and, with meshing.eval_rec, the eval mesh into <output>/mesh/); it
    flushes the mesher at the end."""
    m = slam.cfg["mapping"]
    slam.logger = Logger(slam.output, m["ckpt_freq"], slam.n_img,
                         m["no_log_on_first_frame"])
    os.makedirs(os.path.join(slam.output, "mesh"), exist_ok=True)
    slam.mesher = Mesher(slam.cfg, slam)
    return slam
