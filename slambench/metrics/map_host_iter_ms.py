"""Host milliseconds per mapper iteration: the program's `mapper` spans
(engine/system.py `_map_frame`) outside their `wait.*` spans, over the
window's mapper iterations. The mapper's device time is `map_iter_ms`;
this is what the host spends around it."""

from slambench.program_spans import host_ms_per


def read(ctx):
    return host_ms_per(ctx, "mapper", ctx.map_iters)
