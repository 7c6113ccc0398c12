"""Host milliseconds per frame of `PointNeRFSLAM.step` outside its
phases and waits: the program's `step` spans less their `frontend`,
`tracker`, `mapper` and `wait.*` spans (keyframe insertion, the pose
commit, the back-fill, the frame handover), over the window's frames."""

from slambench.program_spans import PHASES, is_wait, window


def read(ctx):
    w = window(ctx)
    if w is None or not ctx.frames or not w.count(lambda n: n == "step"):
        return None
    return w.outside(lambda n: n == "step",
                     lambda n: n in PHASES or is_wait(n)) / ctx.frames * 1e3
