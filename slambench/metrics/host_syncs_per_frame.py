"""Blocking transfers on the card per frame: the device-to-host reads and
pageable host-to-device copies that the program's `wait.*` spans hold
(each span gives its count), over the window's frames."""

from slambench.program_spans import is_wait, window


def read(ctx):
    w = window(ctx)
    if w is None or not ctx.frames:
        return None
    return w.syncs(is_wait) / ctx.frames
