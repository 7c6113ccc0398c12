"""Host milliseconds of the front-end per tracked frame: the program's
`frontend` spans (the continuous solve and the next tracked frame's
prefetched extraction) outside their `wait.*` spans, so the wait for the
queued mapper is left out."""

from slambench.program_spans import host_ms_per


def read(ctx):
    return host_ms_per(ctx, "frontend", ctx.tracked)
