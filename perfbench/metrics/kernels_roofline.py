"""kernels_roofline (%, device trace): the least time of the profile-2
kernels of every chunk the traced window ran (harness/roofline.py, from
each chunk's coded bins and lanes as its container gives them), over the
device time of every kernel in the window."""
from harness import roofline


def read(ctx):
    if ctx.trace is None or ctx.trace.kernel_s <= 0:
        return None
    least = sum(roofline.least_s(n, k) for r in ctx.done for k, n in ctx.chunks(r))
    return 100.0 * least / ctx.trace.kernel_s if least > 0 else None
