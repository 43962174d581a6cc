"""The share of the traced window in which no kernel, copy or fill ran on
the card (the union of the profiler's device events), in %."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.window_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
