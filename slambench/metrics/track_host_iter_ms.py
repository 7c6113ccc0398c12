"""Host milliseconds per tracker iteration: the program's `tracker` spans
(engine/system.py `_track_frame`) outside their `wait.*` spans, over the
window's tracker iterations."""

from slambench.program_spans import host_ms_per


def read(ctx):
    return host_ms_per(ctx, "tracker", ctx.track_iters)
