"""dense.walk_s_per_mb (s/MB, program span): seconds of the profile-0 dense
walk of each chunk (`native.dense_walk`, on the calling thread) over the
traced window's calls, over the input MB of the files whose container
came."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    return w.s_per_mb(ctx, "native.dense_walk") if w else None
