"""Milliseconds per frame the host spent blocked on the card: the
program's `wait.*` spans (blocking device-to-host reads and pageable
host-to-device copies on the frame path) over the window's frames."""

from slambench.program_spans import is_wait, window


def read(ctx):
    w = window(ctx)
    if w is None or not ctx.frames:
        return None
    return w.seconds(is_wait) / ctx.frames * 1e3
