"""walk.trace_s_per_mb (s/MB, program span): thread-seconds of the native
engine's per-chunk trace walks (`native.trace_walk`, on the analyze workers
and, for chunk 0, the session's pipe) over the traced window's calls, over
the input MB of the files whose container came."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    return w.s_per_mb(ctx, "native.trace_walk") if w else None
