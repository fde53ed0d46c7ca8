"""kernels.ms_per_mb (ms/MB, device trace): the device time of every kernel
in the traced window (torch.profiler's CUDA activity; copies and fills
left out) over the input MB of the files the window ran."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    mb = sum(r.nbytes for r in ctx.done) / 1e6
    return 1e3 * ctx.trace.kernel_s / mb if mb else None
