"""Device milliseconds per mapper iteration: the mapping phases' spans on
the stream (the system's CUDA events around `_map_frame`) over the
window's mapper iterations."""


def read(ctx):
    span = ctx.phase_s.get("mapping", 0.0)
    if not ctx.map_iters or span <= 0.0:
        return None
    return span / ctx.map_iters * 1e3
