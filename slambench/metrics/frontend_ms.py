"""Device-stream milliseconds of the front-end per tracked frame: its
phases' spans (the system's CUDA events around the continuous solve and
the next frame's prefetched extraction), from when the stream reaches the
phase, so the wait for the queued mapper is left out."""


def read(ctx):
    span = ctx.phase_s.get("frontend", 0.0)
    if not ctx.tracked or span <= 0.0:
        return None
    return span / ctx.tracked * 1e3
