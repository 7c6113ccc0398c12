"""Run outputs: the mesher (outputs/mesher.py, outputs/tsdf.py).

The checkpoint logger (resume) and the visualizers of the JAX reference's
outputs/ are not ported yet (ROADMAP Queue 1 items 9 and 11)."""

from __future__ import annotations

import os

from .mesher import Mesher


def attach_outputs(slam):
    """Wire the mesher into a PointNeRFSLAM, as the reference's
    attach_outputs does: PointNeRFSLAM.run then calls
    mesher.maybe_mesh(slam, idx) after every frame (periodic meshes at
    mapping.mesh_freq, the final mesh and, with meshing.eval_rec, the
    eval mesh into <output>/mesh/) and flushes at the end. It wires no
    checkpoint logger and writes no checkpoint (not ported: ROADMAP Queue
    1 item 9), and no visualizer."""
    os.makedirs(os.path.join(slam.output, "mesh"), exist_ok=True)
    slam.mesher = Mesher(slam.cfg, slam)
    return slam
