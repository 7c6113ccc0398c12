"""K2's share of its roofline: the roofline time of every pass-1 sigma
call in the window (one a resample round of the mapper and the tracker,
counted from the shapes, roofline.py) over the device time of K2's kernel
by name (kernels/k2.txt) in the trace."""


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.kernel_seconds(ctx.kernels("k2"))
    if busy <= 0.0:
        return None
    work = ctx.roofline.window_work(ctx.cfg, ctx.trace.map_iters,
                                    ctx.trace.track_iters)
    return 100.0 * work["k2_bound_s"] / busy
