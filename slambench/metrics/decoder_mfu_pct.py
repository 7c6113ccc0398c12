"""The whole step's share of the card's bf16 peak: the decoder operations
of the measured window (K1 and K2 calls counted from the shapes, the
iterations run and the resample rounds, roofline.py) over the window's
seconds (host clock, between its device synchronises) at 989 TFLOP/s.
A cell runs a fixed number of iterations and resample rounds a cycle, so
this is wall_frames_per_s rescaled by the cell's operations a frame: it
moves with wall_frames_per_s by construction, and is kept as the whole
step's share of the peak that bounds any kernel's gain, whatever computes
the decoder."""


def read(ctx):
    if not ctx.map_iters and not ctx.track_iters:
        return None
    work = ctx.roofline.window_work(ctx.cfg, ctx.map_iters, ctx.track_iters)
    return 100.0 * (work["k1_flops"] + work["k2_flops"]) / (
        ctx.seconds * ctx.roofline.PEAK_BF16_FLOPS)
