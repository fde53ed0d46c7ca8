"""walk.copyout_s_per_mb (s/MB, program span): seconds of each chunk's two
copies out of the native engine, `native.copyout` (into a malloc buffer) and
`chunk.take` (into Python bytes), over the traced window's calls, over the
input MB of the files whose container came."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    return w.s_per_mb(ctx, "native.copyout", "chunk.take") if w else None
