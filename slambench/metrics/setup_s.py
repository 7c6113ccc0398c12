"""Seconds from the process's start to the window's opening: imports, the
kernel libraries, casting the frames, building the system, the first map
and the warm-up cycles (host clock)."""


def read(ctx):
    return ctx.setup_s
