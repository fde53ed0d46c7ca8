"""device.idle_share (%, device trace): 1 - the union of the kernel, copy
and fill intervals on the card over the traced window's wall time."""


def read(ctx):
    if ctx.trace is None or not (ctx.trace.kernels or ctx.trace.copies):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
