"""Share of the window in which no kernel, copy or fill ran on the device
(torch.profiler's CUDA activity). The tracer's own cost on the host
(CUPTI, per launch) lengthens the host-bound loop, so this reads above
the idle share of an untraced loop."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
