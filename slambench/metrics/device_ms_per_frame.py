"""Milliseconds of device time a frame holds the card: the window's busy
seconds (the union of every kernel, copy and fill in the device trace,
torch.profiler's CUDA activity) over the window's frames. Nothing to read
where the trace holds no device activity."""


def read(ctx):
    if ctx.trace is None or ctx.frames <= 0 or ctx.trace.busy_s <= 0.0:
        return None
    return ctx.trace.busy_s / ctx.frames * 1e3
