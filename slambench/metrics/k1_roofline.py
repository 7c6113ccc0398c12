"""K1's share of its roofline: the roofline time of every K1 call in the
traced window (one a mapper or tracker iteration, counted from the shapes,
roofline.py) over the device time of K1's kernels by name
(kernels/k1.txt) in the trace. Nothing to read without a trace or where
no kernel of K1's names ran."""


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.kernel_seconds(ctx.kernels("k1"))
    if busy <= 0.0:
        return None
    work = ctx.roofline.window_work(ctx.cfg, ctx.trace.map_iters,
                                    ctx.trace.track_iters)
    return 100.0 * work["k1_bound_s"] / busy
