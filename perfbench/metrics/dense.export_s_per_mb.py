"""dense.export_s_per_mb (s/MB, program span): seconds of the profile-0
dense export of each chunk (`native.dense_export`: the streams, the
within-batch prefix counts and, inside it, the v2 tables,
`native.v2_tables`) over the traced window's calls, over the input MB of
the files whose container came."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    return w.s_per_mb(ctx, "native.dense_export") if w else None
