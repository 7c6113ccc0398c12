"""Device milliseconds per tracker iteration: the tracking phases' spans
on the stream (the system's CUDA events around `_track_frame`) over the
window's tracker iterations."""


def read(ctx):
    span = ctx.phase_s.get("tracking", 0.0)
    if not ctx.track_iters or span <= 0.0:
        return None
    return span / ctx.track_iters * 1e3
