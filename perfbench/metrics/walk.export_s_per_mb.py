"""walk.export_s_per_mb (s/MB, program span): thread-seconds of the native
engine's per-chunk slim exports (`native.export`) over the traced window's
calls, over the input MB of the files whose container came."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    return w.s_per_mb(ctx, "native.export") if w else None
