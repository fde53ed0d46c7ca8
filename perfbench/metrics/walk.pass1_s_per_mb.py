"""walk.pass1_s_per_mb (s/MB, program span): seconds of the native engine's
pass 1 (`native.pass1`, the session opener's slice walk) over the traced
window's calls, over the input MB of the files whose container came."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    return w.s_per_mb(ctx, "native.pass1") if w else None
